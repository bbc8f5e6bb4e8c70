"""The model families' contract leaves both cells' readings where they
were: the DMoE family's leaves, FLOP counts and range prefix for both
configurations, and the tiny cell's checked readings through ``run_cell``
on the CPU, against values frozen from the harness before the DMoE lines
moved into ``families/dmoe.py`` (commit 8a98560) with::

    git archive 8a98560 | tar -x -C <dir> && cd <dir> && python - <<'EOF'
    import sys, time; sys.path[:0] = ["perfbench/tests", "."]
    import torch; torch.set_num_threads(1)
    from conftest import tiny_train
    from perfbench import run as bench
    from perfbench.lib import check
    got, gaps = {}, check.train_gaps
    check.train_gaps = lambda p, r, n=None: (
        got.update(program=p, reference=r) or gaps(p, r, n))
    out = bench.run_cell(tiny_train(), 2**31 + 3, 0.2, False, "cpu",
                         time.perf_counter())
    print(got, out["run"]["numbers"])
    EOF

and, for the leaves, ``hashlib.sha256(repr(weights.leaf_specs(cfg)).encode())``
and ``flops.train_flops_per_step(cfg, batch)`` of each configuration file.
"""

import hashlib
import time

import pytest
import torch

from conftest import tiny_train
from perfbench import run as bench
from perfbench.lib import check, flops, spec

# configuration: (sha256 of repr(leaf_specs), train_flops_per_step at the
# cell's batch, the batch)
LEAVES = {
    "dmoe256-s256": (
        "86ad46d52e83649a0bd0724dd906852d01ac2f4e94a8ac3b2624a3a3ea436d6a",
        168766444929024.0, 2832),
    "dmoe256-s8192": (
        "82566d9b153807ccdb388e5caddaa9ef8c1034ebbe625ccf395191f1dcabefc2",
        378506877861888.0, 108),
}
SEED = 2**31 + 3
FROZEN = {
    "program": {
        "losses": [
            7.3946099281311035, 7.4129958152771],
        "grad_norms": [
            1.3607885969057611, 0.95313783613805, 0.13466404804721627,
            0.10672269213094293, 0.10736662191464637, 0.23241901596298364,
            0.006378646365477448, 0.007373764921966645, 0.5186383598337242,
            0.5128877986879476, 1.0626436024280437, 1.0760566663604432,
            0.05450216722076385, 0.2259700856644779, 0.021830810514037506,
            0.44668501436687635, 0.1125502497587193, 0.06664763696452686,
            0.11505350621728193, 0.004325228806273707, 0.004711632568840473,
            0.24288348207372565, 0.25850884002976604, 0.8522834176057759,
            0.8656200642909827, 0.028772787136750466, 0.1375132576351609,
            0.01222018241670614, 0.2744233929076208, 0.0620068810261808],
        "changes": [
            0.03937690705060959, 0.003277920186519623, 0.0,
            1.4742958228453062e-05, 0.0, 1.3724165910389274e-05, 0.0,
            1.5400608390336856e-05, 0.013032421469688416, 0.013064743019640446,
            0.013124320656061172, 0.012713347561657429, 0.00028634685440920293,
            0.026028303429484367, 8.683531632414088e-05, 0.01304960809648037,
            4.3258023652015254e-05, 0.0, 1.4543613360729069e-05, 0.0,
            1.6742042134865187e-05, 0.012688891962170601, 0.012833112850785255,
            0.013103661127388477, 0.012885620817542076, 0.000322960433550179,
            0.02535318396985531, 8.849309961078689e-05, 0.012712202966213226,
            4.42786404164508e-05],
    },
    "reference": {
        "losses": [
            7.3946099281311035, 7.412992000579834],
        "grad_norms": [
            1.361016869544983, 0.9530211091041565, 0.1345410943031311,
            0.10671371221542358, 0.10735057294368744, 0.2324874997138977,
            0.006374506279826164, 0.007370475679636002, 0.5186365246772766,
            0.5129424333572388, 1.062656044960022, 1.0761357545852661,
            0.05450021103024483, 0.22596874833106995, 0.021827178075909615,
            0.44668257236480713, 0.11253400146961212, 0.06664635241031647,
            0.11500206589698792, 0.004325391724705696, 0.004708664026111364,
            0.24288731813430786, 0.25854018330574036, 0.8522224426269531,
            0.8658093810081482, 0.02877337485551834, 0.13751840591430664,
            0.012219948694109917, 0.27440640330314636, 0.06201254576444626],
        "changes": [
            0.03938134387135506, 0.003276214934885502, 0.0,
            1.4738806385139469e-05, 0.0, 1.3724064046982676e-05, 0.0,
            1.5402771168737672e-05, 0.013049286790192127, 0.013074032962322235,
            0.013147693127393723, 0.012716993689537048, 0.00028621344245038927,
            0.026032233610749245, 8.68359420564957e-05, 0.013050089590251446,
            4.325869304011576e-05, 0.0, 1.454180801374605e-05, 0.0,
            1.6738054910092615e-05, 0.012687919661402702, 0.012819251045584679,
            0.01311404537409544, 0.012878358364105225, 0.0003229569410905242,
            0.02534898929297924, 8.848877041600645e-05, 0.012710285373032093,
            4.428168904269114e-05],
    },
    "numbers": {
        "loss_gap": 5.145961664772631e-07,
        "grad_norm_gap": 0.0009038739245414729,
        "change_gap": 0.0017776861009824309,
    },
}


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_dmoe_leaves_flops_and_ranges(name):
    cfg = spec.load_json(spec.ROOT / "configs" / f"{name}.json")
    family = spec.load_family(cfg["family"])
    digest, step_flops, batch = LEAVES[name]
    specs = family.leaf_specs(cfg)
    assert len(specs) == 56
    assert hashlib.sha256(repr(specs).encode()).hexdigest() == digest
    assert flops.train_flops_per_step(family, cfg, batch) == step_flops
    assert family.RANGE_PREFIX == "dmoe/"
    traffic = spec.load_json(spec.ROOT / "traffic" / f"train-b{batch}.json")
    assert family.program_config(cfg, traffic).num_experts == 256


def test_dmoe_refuses_what_the_port_cannot_run():
    cfg = spec.load_json(spec.ROOT / "configs" / "dmoe256-s256.json")
    traffic = spec.load_json(spec.ROOT / "traffic" / "train-b2832.json")
    family = spec.load_family("dmoe")
    with pytest.raises(ValueError, match="4 \\* d_model"):
        family.program_config(dict(cfg, expert_ffn_dim=1024), traffic)
    with pytest.raises(ValueError, match="head_dim"):
        family.program_config(dict(cfg, head_dim=128), traffic)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tiny_cell_reads_as_before(monkeypatch, one_thread):
    got, gaps = {}, check.train_gaps

    def capture(prog, ref, names=None):
        got.update(program=prog, reference=ref)
        return gaps(prog, ref, names)

    monkeypatch.setattr(check, "train_gaps", capture)
    out = bench.run_cell(tiny_train(), SEED, 0.2, False, "cpu",
                         time.perf_counter())
    got["numbers"] = out["run"]["numbers"]
    for side in ("program", "reference"):
        for key, want in FROZEN[side].items():
            assert got[side][key] == pytest.approx(want, rel=1e-6), (side, key)
    for key, want in FROZEN["numbers"].items():
        assert got["numbers"][key] == pytest.approx(want, rel=1e-6), key
    assert out["result"]["correct"]
