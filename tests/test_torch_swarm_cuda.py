"""The port's swarm server on a CUDA card, against the same server on the
CPU, and its Runtime's double buffering of card work.  The ``cuda``-marked
tests need the card and skip without one; the others run anywhere.  The
file imports torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_swarm_cuda.py

Tolerances: f32 with TF32 off on the card; cuBLAS and the CPU sum the
products in other orders (~1e-6 relative to the terms, which may be far
larger than the sum), so outputs, gradients and sgd updates are held at
the CPU tests' bar for dot products of 16 (2e-5) scaled by sqrt(H / 16)
for products H long, as ``chip_smoke.py``'s card-against-CPU swarm check
scales it: ``atol = rtol = 4e-5`` at H = 64; plus, for the terms summed,
``c * eps_f32 * sqrt(H) * max|ref|`` per output: a gate gradient sums
terms as large as its largest element into elements far smaller.  Each
f32 side is held against the same step in f64 on the CPU (the witness)
at c = 2, the two sides against each other at c = 4.
"""

import asyncio
import contextlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.client.rpc import reset_client_rpc
from learning_at_home_tpu_torch.models.layers import make_expert
from learning_at_home_tpu_torch.optim import sgd
from learning_at_home_tpu_torch.random import PRNGKey
from learning_at_home_tpu_torch.server.runtime import Runtime
from learning_at_home_tpu_torch.server.server import Server, background_server
from learning_at_home_tpu_torch.server.task_pool import BatchJob
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map

H = 64
N = 4
TOL = dict(atol=2e-5 * (H / 16) ** 0.5, rtol=2e-5 * (H / 16) ** 0.5)
LR = 0.05
EPS = float(np.finfo(np.float32).eps)


def _assert_close(got, ref, c: float, what: str) -> float:
    """|got - ref| within TOL's bar plus c f32 roundings of terms as large
    as ref's largest element, summed sqrt(H) deep.  Returns the largest
    |got - ref| in units of ``eps_f32 * sqrt(H) * max|ref|``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    scale = EPS * H ** 0.5 * float(np.abs(ref).max())
    bar = TOL["atol"] + TOL["rtol"] * np.abs(ref) + c * scale
    worst = int(np.argmax(err - bar))
    assert (err <= bar).all(), (
        f"{what}: |err| {err.flat[worst]:.3e} at ref "
        f"{ref.flat[worst]:.3e} over its bar {bar.flat[worst]:.3e} "
        f"(max|ref| {np.abs(ref).max():.3e})")
    return float(err.max()) / scale if scale else 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.fixture(autouse=True)
def _clean_client():
    yield
    reset_client_rpc()


@contextlib.contextmanager
def _twin_servers():
    """The same 4 ffn experts on the card and on the CPU."""
    with background_server(num_experts=N, hidden_dim=H, expert_prefix="cu",
                           optimizer=sgd(LR), device="cuda") as (ep_c, gpu):
        with background_server(num_experts=N, hidden_dim=H,
                               expert_prefix="cu", optimizer=sgd(LR),
                               device="cpu") as (ep_h, cpu):
            for uid, b in gpu.experts.items():
                cpu.experts[uid].load_state_dict(b.state_dict())
            yield (ep_c, gpu), (ep_h, cpu)


def _step(ep, gate, x, cot):
    moe = RemoteMixtureOfExperts(
        in_features=H, grid_size=(N,), uid_prefix="cu", k_best=2,
        source=StaticExpertSource({f"cu.{i}": ep for i in range(N)}))
    g = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in gate.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = moe(xt, g)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), g["w0"].grad.numpy()


def _witness_step(params, gate, x, cot):
    """The same step in f64 on the CPU: the mixture's output and its x and
    gate gradients (top-2 of the gate's logits, softmax over the two,
    every expert answering), and each expert's sgd update applied to
    ``params`` (uid -> its f64 tree)."""
    apply_fn = make_expert("ffn", H, PRNGKey(0), dtype=torch.float64,
                           device="cpu")[0]
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    w0 = torch.tensor(gate["w0"], dtype=torch.float64, requires_grad=True)
    trees = {uid: tree_map(lambda t: t.detach().requires_grad_(True), p)
             for uid, p in params.items()}
    logits = xt @ w0
    top = torch.topk(logits.detach(), 2, dim=1).indices
    outs = torch.stack([apply_fn(trees[f"cu.{e}"], xt) for e in range(N)], 1)
    chosen = torch.gather(outs, 1, top[..., None].expand(-1, -1, H))
    weights = torch.softmax(torch.gather(logits, 1, top), dim=-1)
    y = torch.einsum("bk,bkd->bd", weights, chosen)
    (y * torch.tensor(cot, dtype=torch.float64)).sum().backward()
    for uid, tree in trees.items():
        params[uid] = tree_map(
            lambda t: (t - LR * t.grad if t.grad is not None else t).detach(),
            tree)
    return y.detach().numpy(), xt.grad.numpy(), w0.grad.numpy()


def _f64_params(server) -> dict:
    return {uid: tree_map(lambda t: torch.tensor(np.asarray(t),
                                                 dtype=torch.float64),
                          b.state_dict()["params"])
            for uid, b in server.experts.items()}


def _dense_1(params) -> list:
    return tree_leaves(params["params"]["Dense_1"])


def _steps_against_the_witness(sides, gate, rng) -> dict:
    """Three steps of every ``(label, endpoint, server)`` side from the
    same state, each output held against the f64 witness at c = 2 and
    the sides against the first at c = 4; then each expert's Dense_1
    after the steps.  Prints each side's largest error in units of
    ``eps_f32 * sqrt(H) * max|ref|`` (``pytest -s`` shows it)."""
    witness = _f64_params(sides[0][2])
    worst = {}
    for step in range(3):
        x = rng.standard_normal((32, H)).astype(np.float32)
        cot = rng.standard_normal((32, H)).astype(np.float32)
        ref = _witness_step(witness, gate, x, cot)
        outs = [_step(ep, gate, x, cot) for _, ep, _ in sides]
        for (label, _, _), out in zip(sides, outs):
            for name, a, b, first in zip(("y", "x grad", "gate grad"),
                                         out, ref, outs[0]):
                units = [
                    _assert_close(a, b, 2, f"step {step} {label} {name}"),
                    _assert_close(a, first, 4, f"step {step} {label} "
                                  f"{name} against {sides[0][0]}")]
                for key, u in zip((f"{label} {name} vs f64",
                                   f"{label} {name} vs {sides[0][0]}"),
                                  units):
                    worst[key] = max(worst.get(key, 0.0), u)
    for label, _, srv in sides:
        for uid, backend in srv.experts.items():
            assert backend.update_count == 3
            for a, b in zip(_dense_1(backend.state_dict()["params"]),
                            _dense_1(witness[uid])):
                _assert_close(a, b.numpy(), 2, f"{label} {uid} Dense_1")
    print("largest |err| / (eps_f32 sqrt(H) max|ref|) over 3 steps: "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()
                      if not k.endswith(f"vs {sides[0][0]}")
                      or not k.startswith(sides[0][0])))


def test_cpu_server_matches_an_f64_witness():
    """The witness itself, on the CPU server alone: three steps of the
    mixture through a CPU server agree with the same steps in f64."""
    rng = np.random.default_rng(0)
    gate = {"w0": (rng.standard_normal((H, N)) / 8).astype(np.float32)}
    with background_server(num_experts=N, hidden_dim=H, expert_prefix="cu",
                           optimizer=sgd(LR), device="cpu") as (ep, cpu):
        _steps_against_the_witness([("cpu", ep, cpu)], gate, rng)


@pytest.mark.cuda
def test_server_on_the_card_matches_the_cpu_server(card):
    rng = np.random.default_rng(0)
    gate = {"w0": (rng.standard_normal((H, N)) / 8).astype(np.float32)}
    with _twin_servers() as ((ep_c, gpu), (ep_h, cpu)):
        for b in gpu.experts.values():
            assert all(t.is_cuda for t in b.params["params"]["Dense_0"]
                       .values())
        _steps_against_the_witness(
            [("cpu", ep_h, cpu), ("card", ep_c, gpu)], gate, rng)


@pytest.mark.cuda
def test_card_client_against_an_in_process_card_server(card):
    """Client tensors on the card, server on the card, one process: the
    client's autograd functions take host tensors, so their blocking
    backward runs on the calling thread and leaves autograd's worker
    thread for the card to the server's own backward (a client node on
    that thread would hold it until the RPC timed out)."""
    from learning_at_home_tpu_torch.client.expert import RemoteExpert

    with background_server(num_experts=N, hidden_dim=H, expert_prefix="cu",
                           device="cuda") as (ep, srv):
        moe = RemoteMixtureOfExperts(
            in_features=H, grid_size=(N,), uid_prefix="cu", k_best=2,
            backward_timeout=10.0,
            source=StaticExpertSource({f"cu.{i}": ep for i in range(N)}))
        gen = torch.Generator(device="cuda").manual_seed(0)
        gate = {k: v.requires_grad_(True)
                for k, v in moe.init_gate_params(
                    PRNGKey(0, device="cuda")).items()}
        x = torch.randn((16, H), generator=gen, device="cuda",
                        requires_grad=True)
        for _ in range(2):
            y = moe(x, gate)
            assert y.is_cuda
            y.square().mean().backward()
        assert x.grad.is_cuda and gate["w0"].grad.is_cuda
        expert = RemoteExpert("cu.0", ep, timeout=10.0)
        out = expert(x)
        out.sum().backward()
        assert out.is_cuda
        assert sum(b.update_count for b in srv.experts.values()) == \
            moe.backward_rpcs_sent + 1


@pytest.mark.cuda
def test_create_without_a_device_puts_experts_on_the_card(card):
    srv = Server.create(num_experts=1, hidden_dim=8, start=False)
    try:
        backend = srv.experts["expert.0"]
        assert backend.device.type == "cuda"
        assert backend.opt_state[0].mu["params"]["Dense_0"]["kernel"].is_cuda
    finally:
        srv.shutdown()


def test_create_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server.create(num_experts=1, hidden_dim=8, start=False)


# ---- the Runtime's double buffering ----

class _Pool:
    """The pool surface the Runtime uses: ``process_fn`` launches work on
    ``device`` and returns its (maybe unfinished) output tensors."""

    def __init__(self, name, device, delivered, done):
        self.name = self.serial_key = name
        self.stack_time = 0.0
        self.device = device
        self.delivered, self.done = delivered, done

    def process_fn(self, inputs):
        x = torch.from_numpy(inputs[0]).to(self.device, non_blocking=True)
        for _ in range(20):  # enough card work to still run at return
            x = torch.tanh(x @ x.T @ x / x.shape[1])
        return [x]

    def deliver(self, job, outputs, error):
        self.delivered.append((job.seq, outputs, error))
        if len(self.delivered) == 3:
            self.done.set()


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_runtime_brings_outputs_home_while_the_next_job_runs(device):
    """Three jobs of three pools queued before the Runtime starts: each
    job after the first is launched while its predecessor's outputs are
    still in flight (``jobs_overlapped == 2``), every output reaches the
    host right, and the staging buffers all come back."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    delivered, done = [], threading.Event()
    runtime = Runtime()
    runtime.attach_loop(loop)
    rng = np.random.default_rng(1)
    parts, pools = [], []
    try:
        for i in range(3):
            pool = _Pool(f"p{i}", device, delivered, done)
            pools.append(pool)
            part = rng.standard_normal((3, 64)).astype(np.float32)
            parts.append(part)
            fut = SimpleNamespace()  # row spans are the pool's business
            runtime.submit(BatchJob(
                priority=float(i), seq=i, pool=pool,
                task_tensors=[(part,)], row_spans=[(fut, 0, 3)], n_rows=3,
                target_rows=4, dtypes=[np.dtype(np.float32)]))
        runtime.start()
        assert done.wait(timeout=120)
    finally:
        runtime.shutdown()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
    assert not thread.is_alive()
    assert runtime.jobs_processed == 3 and runtime.jobs_overlapped == 2
    for seq, outputs, error in sorted(delivered, key=lambda d: d[0]):
        assert error is None
        (out,) = outputs
        assert isinstance(out, np.ndarray) and out.shape == (4, 64)
        padded = np.zeros((4, 64), np.float32)
        padded[:3] = parts[seq]
        want = pools[seq].process_fn([padded])[0].cpu().numpy()
        np.testing.assert_allclose(out, want, **TOL)
    stats = runtime.stats()
    assert stats["staging"]["allocated"] >= 1
    assert stats["staging"]["idle_buffers"] == stats["staging"]["allocated"]
