"""The port's swarm server on a CUDA card, against the same server on the
CPU, and its Runtime's double buffering of card work.  The ``cuda``-marked
tests need the card and skip without one; the others run anywhere.  The
file imports torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_swarm_cuda.py

Tolerances: f32 with TF32 off on the card; cuBLAS and the CPU sum the
products in other orders (~1e-6 relative), so outputs, gradients and sgd
updates are held at ``atol = rtol = 2e-5``.
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
from learning_at_home_tpu_torch.optim import sgd
from learning_at_home_tpu_torch.server.runtime import Runtime
from learning_at_home_tpu_torch.server.server import Server, background_server
from learning_at_home_tpu_torch.server.task_pool import BatchJob

H = 64
N = 4
TOL = dict(atol=2e-5, rtol=2e-5)


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
                           optimizer=sgd(0.05), device="cuda") as (ep_c, gpu):
        with background_server(num_experts=N, hidden_dim=H,
                               expert_prefix="cu", optimizer=sgd(0.05),
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


@pytest.mark.cuda
def test_server_on_the_card_matches_the_cpu_server(card):
    rng = np.random.default_rng(0)
    gate = {"w0": (rng.standard_normal((H, N)) / 8).astype(np.float32)}
    with _twin_servers() as ((ep_c, gpu), (ep_h, cpu)):
        for b in gpu.experts.values():
            assert all(t.is_cuda for t in b.params["params"]["Dense_0"]
                       .values())
        for _ in range(3):
            x = rng.standard_normal((32, H)).astype(np.float32)
            cot = rng.standard_normal((32, H)).astype(np.float32)
            got, want = _step(ep_c, gate, x, cot), _step(ep_h, gate, x, cot)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, **TOL)
        for uid in gpu.experts:
            assert gpu.experts[uid].update_count == \
                cpu.experts[uid].update_count
            for a, b in zip(gpu.experts[uid].state_dict()["params"]
                            ["params"]["Dense_1"].values(),
                            cpu.experts[uid].state_dict()["params"]
                            ["params"]["Dense_1"].values()):
                np.testing.assert_allclose(a, b, **TOL)


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
                for k, v in moe.init_gate_params(gen).items()}
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
