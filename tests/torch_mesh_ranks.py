"""Rank-side functions of the port's mesh tests (torch and the port only).

``tests/test_torch_parallel*.py``, ``test_torch_ring_attention.py`` and
``test_torch_multihost.py`` send these to the processes of a
``parallel.launch.RankGroup``: each takes numpy inputs (the JAX package's
global params and batches), runs the port as one rank of a mesh, and
returns numpy results (its local slices), which the tests assemble with
:func:`assemble` and hold against the JAX package on its virtual mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch import random as prng
from learning_at_home_tpu_torch.convert import params_from_jax, tensor_to_numpy
from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
    DMoETransformerLM,
)
from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
from learning_at_home_tpu_torch.parallel import comm
from learning_at_home_tpu_torch.parallel.mesh import (
    data_axes,
    local_shard,
    make_mesh,
    mesh_layout,
    shard_slices,
    spec_axes,
    token_axes,
)
from learning_at_home_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
)
from learning_at_home_tpu_torch.parallel.sharded_moe import (
    ShardedMixtureOfExperts,
)
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map

_MESHES: dict = {}


def mesh_of(axes: dict, device: str = "cpu"):
    """One mesh per layout and device in this rank (its groups are made
    once)."""
    key = (tuple(axes.items()), device)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dict(axes), device=device)
    return _MESHES[key]


def to_np(tree):
    return tree_map(lambda t: np.array(tensor_to_numpy(t), copy=True)
                    if torch.is_tensor(t) else t, tree)


def assemble(per_rank, specs, axes: dict):
    """The global arrays of a tree whose leaves each rank holds a slice of
    (rank r's tree ``per_rank[r]``), by the tree of specs ``specs``."""
    flat_specs = tree_leaves(specs)
    out = []
    for i, spec in enumerate(flat_specs):
        parts = [tree_leaves(t)[i] for t in per_rank]
        layout0 = mesh_layout(axes, 0)
        shape = tuple(s * layout0.size(spec[d] if d < len(spec) and
                                       spec[d] is not None else ())
                      for d, s in enumerate(parts[0].shape))
        full = np.zeros(shape, parts[0].dtype)
        for r, part in enumerate(parts):
            full[shard_slices(shape, spec, mesh_layout(axes, r))] = part
        out.append(full)
    return out


def local_rows(arr, mesh):
    """This rank's rows of a global [N, ...] array (the data axes)."""
    axes = data_axes(mesh)
    n, i = mesh.size(axes), mesh.index(axes)
    rows = arr.shape[0] // n
    return arr[i * rows: (i + 1) * rows]


# ---- the MoE layer ----

def moe(axes, kw, params, x, loss=None, jitter_salt=0):
    """The sharded MoE on this rank's rows of the global tokens ``x``.
    Returns (local y, aux floats, local grads or None).  ``loss``:
    ``"sq_mean_aux"`` = (y²).mean() + 0.01 aux_loss, ``"sq_mean"`` =
    (y²).mean(), ``"sum"`` = y.sum(), over the global tokens: each rank
    adds its share and the shares of each leaf are summed over the token
    axes that do not split it."""
    mesh = mesh_of(axes)
    layer = ShardedMixtureOfExperts(mesh=mesh, **kw)
    specs = layer.param_specs()
    p = {name: torch.from_numpy(local_shard(np.asarray(v), specs[name], mesh)
                                .copy()).requires_grad_(loss is not None)
         for name, v in params.items()}
    xl = torch.from_numpy(local_rows(np.asarray(x), mesh).copy())
    y, aux = layer(p, xl, jitter_salt=jitter_salt)
    grads = None
    if loss is not None:
        n_global = np.asarray(x).shape[0]
        n_tok = mesh.size(token_axes(mesh))
        if loss == "sum":
            share = y.sum()
        else:
            share = (y ** 2).sum() / (n_global * y.shape[1])
            if loss == "sq_mean_aux":
                share = share + 0.01 * aux["aux_loss"] / n_tok
        share.backward()
        grads = {}
        for name, t in p.items():
            g = t.grad
            red = tuple(a for a in token_axes(mesh)
                        if a not in spec_axes(specs[name]))
            comm.all_reduce_tensors_([g], mesh, red)
            grads[name] = g.numpy().copy()
    return (y.detach().numpy().copy(),
            {k: float(v) for k, v in aux.items()}, grads)


def moe_raises(axes, kw):
    """The error message of building the MoE, or None."""
    try:
        ShardedMixtureOfExperts(mesh=mesh_of(axes), **kw)
    except ValueError as e:
        return str(e)
    return None


# ---- the transformer ----

def model(axes, kw):
    return DMoETransformerLM(DMoETransformerConfig(**kw), device="cpu",
                             mesh=mesh_of(axes))


def init_slices(axes, kw, seed: int = 0):
    """The rank's slices of ``init_params(PRNGKey(seed))`` and its param
    specs."""
    m = model(axes, kw)
    params = m.init_params(prng.PRNGKey(seed))
    return to_np(params), m.param_specs(params)


def apply(axes, kw, params, ids, mask=None, replicated=False):
    """Logits and aux of ``apply``: on the rank's part of the global batch,
    or with ``replicated`` on the whole of it."""
    m = model(axes, kw)
    p = params_from_jax(params, m.cfg, "cpu", mesh=m.mesh)
    ids = torch.from_numpy(np.asarray(ids))
    mask = None if mask is None else torch.from_numpy(np.asarray(mask))
    if not replicated:
        ids = m.local_batch(ids)
        mask = None if mask is None else m.local_batch(mask)
    with torch.no_grad():
        logits, aux = m.apply(p, ids, token_mask=mask, replicated=replicated)
    return logits.numpy().copy(), {k: float(v) for k, v in aux.items()}


def loss_and_grads(axes, kw, params, ids, tgt, with_grads: bool = True):
    """(loss, metrics, local grads reduced over the mesh) of ``loss_fn``
    on the rank's part of the global batch."""
    m = model(axes, kw)
    p = params_from_jax(params, m.cfg, "cpu", mesh=m.mesh)
    ids = m.local_batch(torch.from_numpy(np.asarray(ids)))
    tgt = m.local_batch(torch.from_numpy(np.asarray(tgt)))
    if not with_grads:
        with torch.no_grad():
            loss, metrics = m.loss_fn(p, ids, tgt)
        return float(loss), {k: float(v) for k, v in metrics.items()}, None
    (loss, metrics), grads = m.value_and_grad(p, ids, tgt)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            to_np(grads))


def make_optimizer(name: str, lr: float, mesh=None, specs=None):
    if name == "adamw":
        return optim.adamw(lr)
    if name == "sgd":
        return optim.sgd(lr)
    if name == "adafactor":
        return optim.adafactor(lr, mesh=mesh, specs=specs)
    if name == "fused_adafactor":
        return fused_adafactor(lr, mesh=mesh, specs=specs)
    raise ValueError(name)


def train(axes, kw, params, opt_name, lr, batches, accum_steps=1):
    """Steps of ``make_train_step`` from the JAX params on global batches
    (``[(ids, tgt), ...]``; with accumulation each [accum, B, S]).
    Returns (losses, metrics of the last step, final local params)."""
    m = model(axes, kw)
    p = params_from_jax(params, m.cfg, "cpu", mesh=m.mesh)
    opt = make_optimizer(opt_name, lr, m.mesh, m.param_specs(p))
    state = m.init_opt_state(opt, p)
    step = m.make_train_step(opt, accum_steps=accum_steps)
    losses, metrics = [], None
    for ids, tgt in batches:
        ids = torch.from_numpy(np.asarray(ids))
        tgt = torch.from_numpy(np.asarray(tgt))
        if accum_steps > 1:
            ids = torch.stack([m.local_batch(t) for t in ids])
            tgt = torch.stack([m.local_batch(t) for t in tgt])
        else:
            ids, tgt = m.local_batch(ids), m.local_batch(tgt)
        p, state, loss, metrics = step(p, state, ids, tgt)
        losses.append(float(loss))
    return (losses, {k: float(v) for k, v in metrics.items()}, to_np(p))


def generate(axes, kw, params, prompt, n, **gen_kw):
    """``generate``'s tokens (every rank holds the whole output)."""
    m = model(axes, kw)
    p = params_from_jax(params, m.cfg, "cpu", mesh=m.mesh)
    if "rng" in gen_kw:
        gen_kw["rng"] = prng.PRNGKey(gen_kw["rng"])
    out = m.generate(p, torch.from_numpy(np.asarray(prompt)), n, **gen_kw)
    return out.numpy().copy()


def raises(fn_name: str, *args, **kwargs):
    """(error type name, message) of a call of this module's ``fn_name``,
    or None when it returns."""
    try:
        globals()[fn_name](*args, **kwargs)
    except (Exception, SystemExit) as e:  # the test asserts on both
        return type(e).__name__, str(e)
    return None


def attn_impl(axes, kw) -> str:
    return model(axes, kw).cfg.attn_impl


def decode_model_cfg(axes, kw) -> dict:
    dm = model(axes, kw).decode_model()
    return {"gating": dm.cfg.gating, "router_jitter": dm.cfg.router_jitter}


# ---- ring attention ----

def ring(axes, q, k, v, causal=True, layout="contiguous", grads=False):
    """``make_ring_attention``'s global output (every rank alike) and,
    with ``grads``, the gradient of ``(out ** 2).sum()`` for q, k, v."""
    mesh = mesh_of(axes)
    fn = make_ring_attention(mesh, causal=causal, layout=layout)
    qkv = [torch.from_numpy(np.asarray(t)).requires_grad_(grads)
           for t in (q, k, v)]
    out = fn(*qkv)
    g = None
    if grads:
        (out ** 2).sum().backward()
        g = [t.grad.numpy().copy() for t in qkv]
    return out.detach().numpy().copy(), g


def ring_raises(axes, shapes, causal=True, layout="contiguous",
                axis_name="seq"):
    """The ValueError message of building the ring, or of calling it on
    zeros of ``shapes`` (q, k, v), or None."""
    try:
        fn = make_ring_attention(mesh_of(axes), axis_name=axis_name,
                                 causal=causal, layout=layout)
        fn(*(torch.zeros(s) for s in shapes))
    except ValueError as e:
        return str(e)
    return None


# ---- optimizers over a mesh ----

def optimizer_steps(axes, name, lr, params, specs, grads_seq):
    """Steps of a sharded optimizer on this rank's slices of the global
    ``params`` and of each global gradient tree of ``grads_seq``.
    Returns (the final state's leaves, the final params), both local."""
    mesh = mesh_of(axes)
    p = {k: torch.from_numpy(local_shard(np.asarray(v), specs[k], mesh)
                             .copy()) for k, v in params.items()}
    opt = make_optimizer(name, lr, mesh, specs)
    state = opt.init(p)
    for grads in grads_seq:
        g = {k: torch.from_numpy(local_shard(np.asarray(v), specs[k], mesh)
                                 .copy()) for k, v in grads.items()}
        updates, state = opt.update(g, state, p)
        p = optim.applied_updates(p, updates)
    return to_np(tree_leaves(state)), to_np(p)


# ---- the collectives ----

def collectives(axes, device: str = "cpu", dtype=torch.float32):
    """Every collective of ``comm.py`` on fixed inputs and its backward,
    over the whole mesh's first axis.  Returns a dict of numpy results."""
    mesh = mesh_of(axes, device)
    axis = mesh.axis_names[0]
    n, me = mesh.size(axis), mesh.index(axis)
    base = torch.arange(n * 6, dtype=torch.float32).reshape(n, 6) + 100 * me
    x = base.to(device=device, dtype=dtype).requires_grad_(True)
    out = {}
    y = comm.all_to_all(x, mesh, axis)
    (y * (1 + torch.arange(n, device=device)[:, None])).sum().backward()
    out["all_to_all"], out["all_to_all_grad"] = y, x.grad
    for name, fn in (("psum", comm.psum), ("psum_grad", comm.psum_grad),
                     ("pmean", comm.pmean)):
        x.grad = None
        y = fn(x, mesh, axis)
        (y * (me + 1)).sum().backward()
        out[name], out[name + "_grad"] = y, x.grad
    x.grad = None
    perm = [(i, (i + 1) % n) for i in range(n)]
    y = comm.ppermute(x, mesh, axis, perm)
    (y * (me + 1)).sum().backward()
    out["ppermute"], out["ppermute_grad"] = y, x.grad
    x.grad = None
    y = comm.all_gather(x, mesh, axis, dim=1)
    (y * torch.arange(y.shape[1], device=device)).sum().backward()
    out["all_gather"], out["all_gather_grad"] = y, x.grad
    return {k: v.detach().float().cpu().numpy().copy() for k, v in out.items()}


def staged_collectives(axes):
    """:func:`collectives` on the CPU with the mesh staging through host
    copies, as it does for card tensors over gloo."""
    mesh = mesh_of(axes)
    mesh.stage = True
    try:
        return collectives(axes)
    finally:
        mesh.stage = False


def opt_state_specs(axes, kw):
    """``opt_state_shardings`` of adamw's and the Adafactor chain's states
    for the model's params: [(key path, spec entries)] of each."""
    from learning_at_home_tpu_torch.parallel.mesh import (
        _paths,
        opt_state_shardings,
    )

    m = model(axes, kw)
    p = m.init_params(prng.PRNGKey(0))
    specs = m.param_specs(p)
    out = []
    for opt in (optim.adamw(1e-3), optim.adafactor(1e-3, m.mesh, specs)):
        state = opt.init(p)
        shard = opt_state_shardings(state, specs, p)
        out.append([("/".join(map(str, path)), tuple(s))
                    for path, s in _paths(shard)])
    return out


def opt_state_after(axes, kw, params, opt_name, lr, ids, tgt):
    """One train step's loss and the optimizer state's leaves after it
    (local), with their specs."""
    from learning_at_home_tpu_torch.parallel.mesh import opt_state_shardings

    m = model(axes, kw)
    p = params_from_jax(params, m.cfg, "cpu", mesh=m.mesh)
    specs = m.param_specs(p)
    opt = make_optimizer(opt_name, lr, m.mesh, specs)
    state = m.init_opt_state(opt, p)
    step = m.make_train_step(opt)
    p2, state, loss, _ = step(
        p, state, m.local_batch(torch.from_numpy(np.asarray(ids))),
        m.local_batch(torch.from_numpy(np.asarray(tgt))))
    shard = opt_state_shardings(state, specs, p2)
    return float(loss), to_np(state), shard


def convert_slices(axes, kw, params):
    """``params_from_jax`` of the JAX tree on this rank's mesh."""
    m = model(axes, kw)
    return to_np(params_from_jax(params, m.cfg, "cpu", mesh=m.mesh))


def train_lm_main(argv):
    """The port's ``train_lm`` on this rank (its process group is the
    job's); returns what ``main`` returns."""
    from learning_at_home_tpu_torch.experiments import train_lm

    return train_lm.main(list(argv))


def multihost_bringup(params):
    """The JAX multihost worker's steps on this rank: its rows as the
    batch shard, one psum over the mesh, and a sharded MoE forward whose
    all-to-all crosses the processes.  Returns (rank, world, the psum, the
    MoE output's global norm)."""
    import torch.distributed as dist

    from learning_at_home_tpu_torch.parallel.multihost import (
        host_local_array_to_global,
    )

    world = dist.get_world_size()
    mesh = make_mesh({"data": 2, "expert": world // 2}, device="cpu")
    local = np.full((2, 4), float(mesh.rank + 1), np.float32)
    g = host_local_array_to_global(local, mesh, global_shape=(2 * world, 4))
    total = comm.psum(g.sum(), mesh, ("data", "expert"))
    layer = ShardedMixtureOfExperts(4, 2 * (world // 2), k=2,
                                    dtype=torch.float32, mesh=mesh)
    specs = layer.param_specs()
    p = {k: torch.from_numpy(local_shard(np.asarray(v), specs[k], mesh).copy())
         for k, v in params.items()}
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    y, aux = layer(p, torch.from_numpy(local_rows(x, mesh).copy()))
    sq = comm.psum((y ** 2).sum(), mesh, ("data", "expert"))
    return (dist.get_rank(), world, float(total), float(sq.sqrt()),
            float(aux["aux_loss"]))


def nccl_all_reduce(device: str):
    """One NCCL all-reduce over the whole job of a card tensor (a job of
    one rank: the backend's own path, not the mesh's identity)."""
    import torch.distributed as dist

    t = torch.arange(8, dtype=torch.float32, device=device)
    dist.all_reduce(t)
    return dist.get_backend(), t.cpu().numpy().copy()


def fail_on_rank_one():
    """Rank 1 raises; the others wait in a collective it never joins."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.all_reduce(torch.ones(1))


def loss_and_grads_counting_fused_ce(axes, kw, params, ids, tgt):
    """:func:`loss_and_grads`, and how many times the rank took the fused
    CE (``fused_softmax_ce``: K1-K3 on the card, their plain versions on
    the CPU) with how many rows."""
    from learning_at_home_tpu_torch.models import transformer

    calls = []
    fused = transformer.fused_softmax_ce

    def counting(x, *args, **kwargs):
        calls.append(x.shape[0])
        return fused(x, *args, **kwargs)

    transformer.fused_softmax_ce = counting
    try:
        return (*loss_and_grads(axes, kw, params, ids, tgt), calls)
    finally:
        transformer.fused_softmax_ce = fused


def bucketed_reduce(bucket_bytes: int):
    """``comm.all_reduce_tensors_`` over the first axis with buckets of
    ``bucket_bytes``, on tensors of two dtypes, one of them strided;
    returns them as f32 numpy."""
    import torch.distributed as dist

    old, comm.BUCKET_BYTES = comm.BUCKET_BYTES, bucket_bytes
    try:
        mesh = mesh_of({"expert": dist.get_world_size()})
        r = float(dist.get_rank() + 1)
        ts = [torch.full((5,), r), torch.full((3, 4), 2 * r).t(),
              torch.full((40,), r, dtype=torch.bfloat16),
              torch.arange(6.0) * r]
        comm.all_reduce_tensors_(ts, mesh, "expert")
        return [t.float().numpy().copy() for t in ts]
    finally:
        comm.BUCKET_BYTES = old
