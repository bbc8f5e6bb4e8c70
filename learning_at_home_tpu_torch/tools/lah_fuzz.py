#!/usr/bin/env python
"""lah-fuzz: schema-derived hostile-input fuzzing of the four wire
dispatcher families, over the port's classes.

``analysis/fuzz.py`` turns the extracted wire IR + PROTOCOL.md field
rows into a deterministic battery of mutated frames; this harness boots
LIVE in-process instances of all four handler families —

- **expert**   ``server/connection_handler.py`` behind ``background_server``
  (its experts on ``--device``)
- **gateway**  ``gateway/frontdoor.py`` behind a mini expert swarm (the
  experts, the trunk and the KV pool on ``--device``)
- **averaging**  ``averaging/handler.py`` behind ``DecentralizedAverager``
- **dht**      ``dht/protocol.py`` behind ``DHT()``

— and drives every case over a raw TCP socket, classifying each outcome
as error reply / success result / clean close / no-reply.  The contract
under test is tolerate-never-crash: a ``reject``-expected case must NOT
be answered with a success result (the teeth behind ``--selfcheck``), a
``tolerate`` case may be answered any way except a hang, and after every
barrage the family must still serve a fresh benign request (liveness
probe), report zero concurrency-sanitizer violations, and quiesce
cleanly.  Outcome counts are published as ``lah_fuzz_*`` counters
(docs/OBSERVABILITY.md).

Usage (``python -m learning_at_home_tpu_torch.tools.lah_fuzz ...``):
    lah_fuzz --smoke                 # all families, >=200 frames each
    lah_fuzz --family dht --seed 3   # one family, chosen seed
    lah_fuzz --emit-corpus DIR       # write per-family corpus JSONs
    lah_fuzz --replay FILE ...       # replay pinned corpus files
    lah_fuzz --selfcheck             # seeded-bug self-validation
    lah_fuzz --smoke --device cpu    # the live hosts on the CPU

The expert and gateway hosts run on the CUDA card unless ``--device``
names another (they raise where there is no card); the averaging and
DHT hosts hold no tensors on a device.

Exit codes: 0 clean, 1 contract violations (crash / hang / wrong reply
class / sanitizer violation / selfcheck found nothing), 2 harness error.
"""

import argparse
import contextlib
import json
import os
import socket
import struct
import sys
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_U32 = struct.Struct("<I")

MIN_PER_FAMILY = 220
RECV_TIMEOUT_S = 4.0
PROBE_EVERY = 50


# ---------------------------------------------------------------------------
# raw socket driver
# ---------------------------------------------------------------------------


def _recv_exact(sock, n: int):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _classify_reply(payload: bytes) -> str:
    """error-shaped vs success reply.  Every family's error shape is one
    of: msg_type ``error``, or a reply meta map carrying an ``error``
    key (the DHT's ``r`` frames, the gateway's poll bodies)."""
    import msgpack

    try:
        (hlen,) = _U32.unpack_from(payload, 0)
        header = msgpack.unpackb(payload[4:4 + hlen], raw=False)
        msg_type, meta = header.get("t"), header.get("m")
    except Exception:
        return "close"  # unparseable reply == broken connection to us
    if msg_type == "error":
        return "reject"
    if isinstance(meta, dict) and meta.get("error") is not None:
        return "reject"
    return "result"


def drive_case(endpoint, case, timeout: float = RECV_TIMEOUT_S) -> str:
    """One case over one fresh connection.  Outcomes: ``reject`` |
    ``result`` | ``close`` | ``noreply`` | ``connect_fail``."""
    try:
        sock = socket.create_connection(endpoint, timeout=timeout)
    except OSError:
        return "connect_fail"
    with contextlib.closing(sock):
        sock.settimeout(timeout)
        try:
            sock.sendall(case.frame())
        except OSError:
            return "close"
        if not case.wait:
            # by construction unanswerable (lying/truncated framing):
            # write, close, let the liveness probe assert survival
            return "close"
        try:
            head = _recv_exact(sock, 4)
            if head is None:
                return "close"
            (length,) = _U32.unpack(head)
            if length > (1 << 30):
                return "close"
            payload = _recv_exact(sock, length)
            if payload is None:
                return "close"
        except socket.timeout:
            return "noreply"
        except OSError:
            return "close"
        return _classify_reply(payload)


def probe(endpoint, op: str, meta: dict, timeout: float = 8.0) -> bool:
    """Fresh-connection benign request; True iff a success reply comes
    back — the liveness signal between hostile cases."""
    import msgpack

    header = msgpack.packb({"t": op, "m": meta, "ts": []}, use_bin_type=True)
    frame = _U32.pack(4 + len(header)) + _U32.pack(len(header)) + header
    try:
        sock = socket.create_connection(endpoint, timeout=timeout)
    except OSError:
        return False
    with contextlib.closing(sock):
        sock.settimeout(timeout)
        try:
            sock.sendall(frame)
            head = _recv_exact(sock, 4)
            if head is None:
                return False
            (length,) = _U32.unpack(head)
            payload = _recv_exact(sock, length)
            if payload is None:
                return False
        except OSError:
            return False
        return _classify_reply(payload) == "result"


# ---------------------------------------------------------------------------
# live family hosts
# ---------------------------------------------------------------------------


def _where(srv) -> str:
    """The device the server's experts live on."""
    return ",".join(sorted({str(b.device) for b in srv.experts.values()}))


@contextlib.contextmanager
def expert_host(device=None):
    from learning_at_home_tpu_torch.optim import sgd
    from learning_at_home_tpu_torch.server.server import background_server

    with background_server(
        num_experts=2, hidden_dim=16, expert_prefix="fz", seed=0,
        optimizer=sgd(0.0), device=device,
    ) as (endpoint, srv):
        yield endpoint, ("stats", {}), _where(srv)


@contextlib.contextmanager
def gateway_host(device=None):
    from learning_at_home_tpu_torch import random as jrandom
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.client.routing import StaticExpertSource
    from learning_at_home_tpu_torch.gateway import Gateway
    from learning_at_home_tpu_torch.models.transformer_swarm import (
        SwarmDMoETransformerLM,
        SwarmTransformerConfig,
    )
    from learning_at_home_tpu_torch.server.server import background_server

    uids = [f"fzg{layer}.{e}" for layer in range(2) for e in range(2)]
    cfg = SwarmTransformerConfig(
        vocab_size=32, d_model=16, n_layers=2, n_heads=4, seq_len=16,
        grid_size=(2,), k_best=2, k_min=2, uid_prefix="fzg",
        timeout_after_k_min=30.0, forward_timeout=60.0,
        backward_timeout=60.0, wire_codec="none", routing_cost_weight=0,
    )
    with background_server(
        expert_uids=uids, hidden_dim=16, seed=0, device=device
    ) as (endpoint, srv):
        src = StaticExpertSource({u: endpoint for u in uids})
        model = SwarmDMoETransformerLM(cfg, src)
        params = model.init_params(jrandom.PRNGKey(0), device=device)
        with Gateway(model, params, max_slots=4, device=device) as gw:
            yield gw.endpoint, ("stats", {}), _where(srv)
    reset_client_rpc()


@contextlib.contextmanager
def averaging_host():
    from learning_at_home_tpu_torch.averaging import (
        AveragingConfig,
        DecentralizedAverager,
    )
    from learning_at_home_tpu_torch.dht import DHT

    dht = DHT()
    # short part/orphan timeouts: a held avg_part reply for a group no
    # round ever attaches must fail over to an error reply well inside
    # the driver's recv window, not the 30 s production orphan TTL
    av = DecentralizedAverager(
        dht,
        config=AveragingConfig(part_timeout=1.0, orphan_ttl=1.0),
        peer_id="fuzz-peer",
    )
    try:
        yield av.endpoint, ("avg_stats", {}), "host"
    finally:
        av.shutdown()
        dht.shutdown()


@contextlib.contextmanager
def dht_host():
    from learning_at_home_tpu_torch.dht import DHT
    from learning_at_home_tpu_torch.dht.routing import DHTID

    dht = DHT()
    probe_meta = {"from": DHTID.from_key(b"fuzz-probe").to_bytes(),
                  "port": 1}
    try:
        yield dht.endpoint, ("ping", probe_meta), "host"
    finally:
        dht.shutdown()


HOSTS = {
    "expert": expert_host,
    "gateway": gateway_host,
    "averaging": averaging_host,
    "dht": dht_host,
}
DEVICE_FAMILIES = ("expert", "gateway")  # the hosts that take ``device``


# ---------------------------------------------------------------------------
# barrage runner
# ---------------------------------------------------------------------------


def _counters():
    from learning_at_home_tpu_torch.analysis.fuzz import FUZZ_COUNTERS
    from learning_at_home_tpu_torch.utils.metrics import registry

    return {name: registry.counter(name, "lah_fuzz outcome counter")
            for name in FUZZ_COUNTERS}


_OUTCOME_COUNTER = {
    "reject": "lah_fuzz_rejects_total",
    "result": "lah_fuzz_results_total",
    "close": "lah_fuzz_closes_total",
    "noreply": "lah_fuzz_hangs_total",
}


def run_family(family: str, cases: list, verbose: bool = False,
               device=None) -> dict:
    """Boot the family's live instance (the expert and gateway hosts on
    ``device``), drive its cases, enforce the contract.  Returns a report
    with per-outcome counts, failures, each case's outcome in order
    (``case_outcomes``) and where the host's tensors lived (``device``)."""
    from learning_at_home_tpu_torch.utils import sanitizer

    counters = _counters()
    report = {
        "family": family, "frames": 0, "failures": [],
        "outcomes": {"reject": 0, "result": 0, "close": 0, "noreply": 0},
        "sanitizer_violations": 0, "quiesce_leaks": [],
        "case_outcomes": [],
    }
    sanitizer.clear_violations()
    t0 = time.monotonic()
    host = (HOSTS[family](device) if family in DEVICE_FAMILIES
            else HOSTS[family]())
    with host as (endpoint, (probe_op, probe_meta), where):
        report["device"] = where
        if not probe(endpoint, probe_op, probe_meta):
            report["failures"].append(
                {"case": "<initial probe>", "why": "family never came up"}
            )
            return report
        for i, case in enumerate(cases):
            outcome = drive_case(endpoint, case)
            counters["lah_fuzz_frames_total"].inc(1, family=family)
            report["frames"] += 1
            report["case_outcomes"].append((case.name, outcome))
            if outcome == "connect_fail":
                counters["lah_fuzz_crashes_total"].inc(1, family=family)
                report["failures"].append(
                    {"case": case.name, "why": "listener gone (crash?)"}
                )
                break
            report["outcomes"][outcome] += 1
            counters[_OUTCOME_COUNTER[outcome]].inc(1, family=family)
            bad = None
            if outcome == "noreply":
                bad = "no reply within deadline (hang)"
            elif case.expect == "reject" and outcome == "result":
                bad = "success result where a rejection is required"
            if bad:
                report["failures"].append(
                    {"case": case.name, "why": bad,
                     "mutation": case.mutation, "outcome": outcome}
                )
            if bad or (i + 1) % PROBE_EVERY == 0:
                if not probe(endpoint, probe_op, probe_meta):
                    counters["lah_fuzz_crashes_total"].inc(1, family=family)
                    report["failures"].append(
                        {"case": case.name,
                         "why": "liveness probe failed after this case"}
                    )
                    break
        if not probe(endpoint, probe_op, probe_meta):
            counters["lah_fuzz_crashes_total"].inc(1, family=family)
            report["failures"].append(
                {"case": "<final probe>", "why": "family dead after barrage"}
            )
        viol = sanitizer.violations()
        if viol:
            report["sanitizer_violations"] = len(viol)
            report["failures"].append(
                {"case": "<sanitizer>",
                 "why": f"{len(viol)} violation(s): {viol[:3]}"}
            )
    report["quiesce_leaks"] = sanitizer.quiesce_point(f"fuzz-{family}")
    if report["quiesce_leaks"]:
        report["failures"].append(
            {"case": "<quiesce>",
             "why": f"leaked threads: {report['quiesce_leaks']}"}
        )
    report["elapsed_s"] = round(time.monotonic() - t0, 2)
    if verbose:
        for f in report["failures"]:
            print(f"  FAIL {family}: {f}", file=sys.stderr)
    return report


# ---------------------------------------------------------------------------
# seeded-bug self-validation
# ---------------------------------------------------------------------------


def selfcheck(seed: int, device=None) -> int:
    """Drop a handler's field validation and require the fuzzer to find
    it: ``Gateway._gen_submit`` is monkeypatched to skip its structural
    checks and accept anything, so the ``gen_submit`` drop-required
    probes come back as success results — if the barrage does NOT flag
    that as a contract violation, the fuzzer has no teeth and this
    command exits 1."""
    from learning_at_home_tpu_torch.analysis.fuzz import generate_cases
    from learning_at_home_tpu_torch.gateway import frontdoor

    cases = [
        c for c in generate_cases(
            seed, [PKG],
            families=("gateway",), min_per_family=0,
        )
        if c.op == "gen_submit"
    ]
    original = frontdoor.Gateway._gen_submit

    def lenient(self, meta):
        # the seeded bug: no prompt/max_new_tokens validation at all
        return {"accepted": False, "sid": "selfcheck", "shed": True,
                "retry_after_s": 0.01}

    frontdoor.Gateway._gen_submit = lenient
    try:
        report = run_family("gateway", cases, device=device)
    finally:
        frontdoor.Gateway._gen_submit = original
    missed = [
        f for f in report["failures"]
        if f.get("why", "").startswith("success result")
    ]
    if not missed:
        print("lah-fuzz: SELFCHECK FAILED — seeded validation bug was NOT "
              "detected", file=sys.stderr)
        print(json.dumps(report, indent=1), file=sys.stderr)
        return 1
    print(f"lah-fuzz: selfcheck OK — seeded gen_submit bug detected by "
          f"{len(missed)} probe(s) out of {report['frames']} frames")
    return 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="full battery over every family")
    p.add_argument("--family", choices=("expert", "gateway", "averaging",
                                        "dht"), action="append")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-per-family", type=int, default=MIN_PER_FAMILY)
    p.add_argument("--emit-corpus", metavar="DIR",
                   help="write per-family corpus JSONs and exit")
    p.add_argument("--replay", metavar="FILE", action="append",
                   help="replay pinned corpus file(s) instead of generating")
    p.add_argument("--selfcheck", action="store_true",
                   help="seeded-bug self-validation (must exit 0)")
    p.add_argument("--device", default=None,
                   help="where the expert and gateway hosts run "
                        "(default: the CUDA card)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from learning_at_home_tpu_torch.analysis.fuzz import (
        FAMILIES,
        STATEFUL_OPS,
        dump_corpus,
        generate_cases,
        load_corpus,
    )

    if args.selfcheck:
        return selfcheck(args.seed, device=args.device)

    families = tuple(args.family) if args.family else FAMILIES
    pkg = PKG

    if args.replay:
        cases = []
        for path in args.replay:
            cases.extend(load_corpus(path))
        cases = [c for c in cases if c.family in families]
    else:
        cases = generate_cases(
            args.seed, [pkg], families=families,
            min_per_family=args.min_per_family,
        )

    if args.emit_corpus:
        os.makedirs(args.emit_corpus, exist_ok=True)
        # pin only compact frames: the MiB-scale oversize-payload cases
        # would bloat the checked-in corpus ~1000x and are regenerated
        # bit-identically from the seed by every --smoke run anyway
        max_hex = 2 * 64 * 1024
        for fam in families:
            fam_cases = [c for c in cases
                         if c.family == fam and len(c.frame_hex) <= max_hex]
            dropped = sum(1 for c in cases if c.family == fam) - len(fam_cases)
            out = os.path.join(args.emit_corpus, f"{fam}.json")
            dump_corpus(fam_cases, out, meta={"seed": args.seed,
                                              "family": fam,
                                              "oversize_dropped": dropped})
            print(f"lah-fuzz: wrote {len(fam_cases)} cases -> {out} "
                  f"({dropped} oversize case(s) left to live generation)")
        return 0

    if not (args.smoke or args.replay or args.family):
        p.print_help()
        return 2

    print(f"lah-fuzz: seed={args.seed} families={','.join(families)} "
          f"(stateful ops excluded from the live barrage: "
          f"{', '.join(STATEFUL_OPS)})")
    reports = []
    for fam in families:
        fam_cases = [c for c in cases if c.family == fam]
        if not fam_cases:
            continue
        rep = run_family(fam, fam_cases, verbose=args.verbose,
                         device=args.device)
        reports.append(rep)
        status = "OK" if not rep["failures"] else "FAIL"
        print(
            f"lah-fuzz: {fam}: {status} frames={rep['frames']} "
            f"rejects={rep['outcomes']['reject']} "
            f"results={rep['outcomes']['result']} "
            f"closes={rep['outcomes']['close']} "
            f"hangs={rep['outcomes']['noreply']} "
            f"sanitizer={rep['sanitizer_violations']} "
            f"device={rep.get('device')} ({rep['elapsed_s']}s)"
        )
    failures = [f for rep in reports for f in rep["failures"]]
    if failures:
        print(f"lah-fuzz: FAIL — {len(failures)} contract violation(s):",
              file=sys.stderr)
        for f in failures[:20]:
            print(f"  {f}", file=sys.stderr)
        return 1
    total = sum(rep["frames"] for rep in reports)
    print(f"lah-fuzz: OK — {total} frames, 0 crashes, 0 hangs, "
          f"0 sanitizer violations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
