"""The port's sizing (``utils/sizing.py``) against ``bench.py``'s and
``experiments/profile_step.py``'s, at the full flagship width (neither
side allocates: the JAX side sizes with ``jax.eval_shape``, the port
with meta tensors).

Tolerance: none.  FLOPs (a float) and every byte count (integers) must
be equal, for each optimizer (the fused Adafactor, optax's chain,
AdamW), param layout (stacked and scanned, stacked, the per-layer
tuple), param dtype (f32, bf16), remat setting (``full``, ``dots``, off)
and batch.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import bench
from __graft_entry__ import _flagship
from learning_at_home_tpu.ops.fused_adafactor import (
    fused_adafactor as jax_fused_adafactor,
)
from learning_at_home_tpu.parallel.mesh import make_mesh
from learning_at_home_tpu_torch.experiments.profile_step import make_optimizer
from learning_at_home_tpu_torch.utils import sizing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_OPTIMIZERS = {"fused": lambda: jax_fused_adafactor(1e-3),
                  "adafactor": lambda: optax.adafactor(1e-3),
                  "adamw": lambda: optax.adamw(1e-3)}
LAYOUTS = {"stacked-scanned": dict(stack_layers=True, scan_layers=True),
           "stacked": dict(stack_layers=True, scan_layers=False),
           "tuple": dict(stack_layers=False, scan_layers=False)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
REMAT = {"full": dict(remat=True, remat_policy="full"),
         "dots": dict(remat=True, remat_policy="dots"),
         "off": dict(remat=False)}
BATCHES = (1, 2, 176, 4096)


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", os.path.join(REPO, "experiments",
                                                f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the JAX script's own; its module imports nothing but the standard library
jax_dots_extra_bytes = jax_script("profile_step").dots_extra_bytes


@pytest.fixture(scope="module")
def jax_flagship():
    mesh = make_mesh({"expert": 1}, devices=jax.devices()[:1])
    model, cfg = _flagship(mesh)
    return mesh, type(model), cfg


def pair(jax_flagship, **over):
    """(JAX model, port config) of the flagship with ``over`` applied;
    dtypes as (jax, torch) pairs."""
    mesh, cls, jcfg = jax_flagship
    jover = {k: v[0] if isinstance(v, tuple) else v for k, v in over.items()}
    tover = {k: v[1] if isinstance(v, tuple) else v for k, v in over.items()}
    jcfg = dataclasses.replace(jcfg, **jover)
    return cls(jcfg, mesh), sizing.flagship_config(**tover)


def test_flagship_config_is_the_jax_entry_points(jax_flagship):
    _, _, jcfg = jax_flagship
    tcfg = sizing.flagship_config()
    for field in dataclasses.fields(tcfg):
        want = getattr(jcfg, field.name)
        got = getattr(tcfg, field.name)
        if isinstance(got, torch.dtype):
            assert str(got).split(".")[-1] == jnp.dtype(want).name, field.name
        else:
            assert got == want, field.name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("optimizer", sorted(JAX_OPTIMIZERS))
def test_static_state_bytes(jax_flagship, optimizer, layout, dtype):
    model, tcfg = pair(jax_flagship, param_dtype=DTYPES[dtype],
                       **LAYOUTS[layout])
    want = bench._static_state_bytes(model, JAX_OPTIMIZERS[optimizer]())
    got = sizing._static_state_bytes(tcfg, make_optimizer(optimizer))
    assert got == want


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("compute", sorted(DTYPES))
@pytest.mark.parametrize("remat", sorted(REMAT))
def test_activation_and_flops(jax_flagship, remat, compute, batch):
    model, tcfg = pair(jax_flagship, dtype=DTYPES[compute], **REMAT[remat])
    jcfg = model.cfg
    assert sizing._activation_bytes(tcfg, batch) == \
        bench._activation_bytes(jcfg, batch)
    assert sizing.dots_extra_bytes(tcfg, batch) == \
        jax_dots_extra_bytes(jcfg, batch)
    assert sizing._model_flops_per_step(tcfg, batch) == \
        bench._model_flops_per_step(jcfg, batch)


@pytest.mark.parametrize("remat", sorted(REMAT))
def test_estimated_peak_is_profile_steps(jax_flagship, remat):
    """The refusal's estimate: profile_step.py's sum (the dots term under
    remat "dots" only), bf16 params, the tuple layout, the fused
    Adafactor, batch 176."""
    model, tcfg = pair(jax_flagship, param_dtype=DTYPES["bf16"],
                       **LAYOUTS["tuple"], **REMAT[remat])
    jcfg = model.cfg
    want = bench._static_state_bytes(model, JAX_OPTIMIZERS["fused"]()) + \
        bench._activation_bytes(jcfg, 176)
    if jcfg.remat and jcfg.remat_policy == "dots":
        want += jax_dots_extra_bytes(jcfg, 176)
    assert sizing.estimated_peak_bytes(tcfg, make_optimizer("fused"),
                                       176) == want


def test_tree_bytes_counts_meta_and_real_tensors(jax_flagship):
    tree = {"a": torch.empty(3, 4, device="meta", dtype=torch.bfloat16),
            "b": (torch.zeros(5, dtype=torch.float32),
                  torch.zeros((), dtype=torch.int32))}
    assert sizing._tree_bytes(tree) == 3 * 4 * 2 + 5 * 4 + 4
    model, tcfg = pair(jax_flagship, param_dtype=DTYPES["bf16"],
                       **LAYOUTS["tuple"])
    abstract = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    params = sizing.abstract_params(tcfg)
    assert all(t.device.type == "meta" for t in sizing.tree_leaves(params))
    assert sizing._tree_bytes(params) == bench._tree_bytes(abstract)


def test_card_constants_are_the_h100_data_sheets():
    assert sizing.CARD_PEAK_BF16 == {"NVIDIA H100 80GB HBM3": 989e12}
    assert sizing.CARD_HBM_BPS == {"NVIDIA H100 80GB HBM3": 3.35e12}
