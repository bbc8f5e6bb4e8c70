"""ExpertBackend: one expert's parameters + optimizer on the card.

The port of ``learning_at_home_tpu/server/expert_backend.py``.  Behavioral
contract from the reference's ``hivemind/server/expert_backend.py``
(SURVEY.md §2 [BJ]):

- ``forward(batch)`` runs the expert on a batch;
- ``backward(batch, grad_outputs)`` computes input-gradients to return to
  the caller AND **immediately applies the optimizer step** to the
  expert's own parameters — the asynchronous update at the heart of
  Learning@home.  No global barrier; staleness is tolerated by design.

Parameters and optimizer state live on the backend's device (the CUDA
card unless ``device="cpu"``).  Forward runs under ``torch.no_grad()``;
backward is ONE autograd re-forward of the batch (the JAX package's
``jax.vjp``), then the optimizer step written into the parameters in
place under the state lock.  Torch's grad mode is thread-local and the
Runtime's thread starts in the default mode, so each entry point sets
its own.  Both return tensors on the device whose kernels may still be
running; the Runtime brings them to the host (``server/runtime.py``).
All state mutation happens on the Runtime's one thread, which never has
a forward and a backward of one expert in flight together.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from learning_at_home_tpu_torch.convert import (
    numpy_dtype,
    numpy_to_tensor,
    tensor_to_numpy,
)
from learning_at_home_tpu_torch.device import resolve_device
from learning_at_home_tpu_torch.optim import GradientTransformation, apply_updates
from learning_at_home_tpu_torch.tree import tree_map
from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.utils.nested import (
    nested_flatten,
    nested_pack,
    nested_structure,
)

logger = logging.getLogger(__name__)


class ExpertBackend:
    """An expert module + its optimizer, executed on one device.

    Args:
        name: globally-unique expert UID (e.g. ``"ffn.4.17"``).
        apply_fn: ``(params, *inputs) -> output`` over tensors; with
            ``input_structure``: ``(params, tree) -> output``, the flat
            wire tensors repacked into ONE nest shaped like
            ``input_structure`` before the call.
        params: initial parameter tree (tensors or numpy arrays; moved to
            ``device``).
        optimizer: an ``optim.GradientTransformation`` (``optim.adam``,
            ``optim.sgd``, ...).
        max_batch_size: upper bound on rows per executed batch; also the
            largest bucket.
        device: where params, optimizer state and compute live (None: the
            CUDA card; raises where there is none).
    """

    def __init__(
        self,
        name: str,
        apply_fn: Callable,
        params: Any,
        optimizer: GradientTransformation,
        max_batch_size: int = 1024,
        opt_state: Any = None,
        n_inputs: int = 1,
        input_structure: Any = None,
        device=None,
    ):
        self.name = name
        self.apply_fn = apply_fn
        self.optimizer = optimizer
        self.max_batch_size = max_batch_size
        self.device = resolve_device(device)
        # pytree inputs (SURVEY §2 "Nested structures"): wire tensors are
        # flat; an optional example structure repacks them into apply_fn's
        # argument nest, and its schema travels in the info RPC
        self.input_structure = input_structure
        if input_structure is not None:
            self._input_treedef = nested_structure(input_structure)
            structure_arity = len(nested_flatten(input_structure))
            if n_inputs != 1 and n_inputs != structure_arity:
                raise ValueError(
                    f"n_inputs={n_inputs} contradicts input_structure with "
                    f"{structure_arity} leaves — pass only one of them"
                )
            n_inputs = structure_arity
        else:
            self._input_treedef = None
        self.n_inputs = n_inputs  # wire arity: tensors before grad_outputs
        # output wire arity and per-leaf schema (row dim stripped), set at
        # warmup or the first forward; the info RPC publishes the schema
        self.n_outputs: Optional[int] = None
        self.output_schema: Optional[list] = None
        # buckets warmup() ran: the TaskPool's cold/hit telemetry counts a
        # first-seen bucket outside this set as cold
        self.warm_buckets: frozenset[int] = frozenset()
        self.params = tree_map(self._on_device, params)
        self.opt_state = (
            tree_map(self._on_device, opt_state)
            if opt_state is not None
            else optimizer.init(self.params)
        )
        self.update_count = 0
        # guards params/opt_state against torn reads: backward rewrites
        # them in place on the Runtime thread; state_dict may be called
        # from any thread
        self._state_lock = sanitizer.lock("server.expert_state")

    def _on_device(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.detach().to(self.device).clone()
        return numpy_to_tensor(np.array(value, copy=True), self.device)

    def _inputs(self, arrays: Sequence) -> list[torch.Tensor]:
        """The batch's host arrays on the device.  A copy to the card from
        a staging buffer must finish before the Runtime recycles it; it
        does: the Runtime releases a buffer after the job's outputs, later
        in the same stream, reached the host."""
        return [numpy_to_tensor(a, self.device, non_blocking=True)
                if not isinstance(a, torch.Tensor) else a.to(self.device)
                for a in arrays]

    def _apply(self, params, inputs: Sequence[torch.Tensor]):
        if self._input_treedef is not None:
            tree = nested_pack(inputs, self._input_treedef)
            return self.apply_fn(params, tree)
        return self.apply_fn(params, *inputs)

    # ---- runtime-thread entry points (NOT thread-safe by themselves;
    #      the Runtime serializes all calls per process) ----

    def forward(self, inputs: Sequence[np.ndarray]) -> list[torch.Tensor]:
        """Run the expert on one padded batch; returns flat output
        tensors on the device."""
        xs = self._inputs(inputs)
        with torch.no_grad():
            leaves = nested_flatten(self._apply(self.params, xs))
        self._record_output_schema(leaves)
        return leaves

    def _record_output_schema(self, leaves) -> None:
        """Outputs are row-aligned with inputs (the TaskPool scatters rows
        back per task), so shape[0] is the batch dim and shape[1:] is the
        wire-stable per-row schema."""
        self.n_outputs = len(leaves)
        self.output_schema = [
            {"shape": [int(d) for d in l.shape[1:]],
             "dtype": str(numpy_dtype(l.dtype))}
            for l in leaves
        ]

    def _vjp(self, params, xs, grads_out):
        """Input and parameter gradients of one re-forward: f32 zeros for
        integer inputs (the JAX package ships them for its float0
        cotangents; the client drops them)."""
        with torch.enable_grad():
            leaves, treedef = _flatten_params(params)
            p = [t.detach().requires_grad_(True) for t in leaves]
            diff = [i for i, x in enumerate(xs) if x.is_floating_point()]
            xg = list(xs)
            for i in diff:
                xg[i] = xs[i].detach().requires_grad_(True)
            outs = nested_flatten(self._apply(treedef(p), xg))
            if len(outs) != len(grads_out):
                raise ValueError(
                    f"expert {self.name} has {len(outs)} outputs, got "
                    f"{len(grads_out)} grad_outputs")
            grads = torch.autograd.grad(
                outs, p + [xg[i] for i in diff],
                [g.to(o.dtype) for g, o in zip(grads_out, outs)],
                allow_unused=True)
        param_grads = [torch.zeros_like(t) if g is None else g
                       for t, g in zip(p, grads[:len(p)])]
        input_grads = [torch.zeros(x.shape, dtype=torch.float32,
                                   device=x.device) for x in xs]
        for i, g in zip(diff, grads[len(p):]):
            input_grads[i] = torch.zeros_like(xs[i]) if g is None else g
        return treedef(param_grads), input_grads

    def backward(
        self, inputs: Sequence[np.ndarray], grad_outputs: Sequence[np.ndarray]
    ) -> list[torch.Tensor]:
        """Return input-grads AND apply the optimizer step in place."""
        xs = self._inputs(inputs)
        gs = self._inputs(grad_outputs)
        with self._state_lock:
            param_grads, input_grads = self._vjp(self.params, xs, gs)
            updates, self.opt_state = self.optimizer.update(
                param_grads, self.opt_state, self.params
            )
            apply_updates(self.params, updates)
            self.update_count += 1
        return input_grads

    # ---- metadata / checkpoint ----

    def warmup(self, sample_inputs: Sequence[np.ndarray], buckets=None) -> int:
        """Record the batch buckets the Runtime will execute and the output
        schema, as the JAX backend's warmup does; there is nothing to
        compile ahead (torch launches eagerly).  One forward of the
        smallest bucket, without a backward (no state changes), sets the
        schema.  Returns the number of buckets."""
        from learning_at_home_tpu_torch.server.task_pool import bucket_rows

        if buckets is None:
            b = 1
            buckets = []
            while b < self.max_batch_size:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch_size)
        buckets = sorted({bucket_rows(b, self.max_batch_size) for b in buckets})
        padded = [
            np.zeros((buckets[0], *np.shape(t)[1:]), np.asarray(t).dtype)
            for t in sample_inputs
        ]
        self.forward(padded)
        self.warm_buckets = self.warm_buckets | frozenset(buckets)
        return len(buckets)

    def get_info(self) -> dict:
        """Serializable expert metadata (for the ``info`` RPC)."""
        info = {
            "name": self.name,
            "max_batch_size": self.max_batch_size,
            "n_inputs": self.n_inputs,
            "num_params": int(sum(t.numel() for t in nested_flatten(self.params))),
            "update_count": self.update_count,
        }
        if self.input_structure is not None:
            from learning_at_home_tpu_torch.utils.nested import schema_from_tree

            info["input_schema"] = schema_from_tree(self.input_structure)
        if self.output_schema is not None:
            info["output_schema"] = self.output_schema
        return info

    def state_dict(self) -> dict:
        """Host-side snapshot of params + opt state (numpy; checkpoints)."""
        with self._state_lock:
            return {
                "params": tree_map(_host_copy, self.params),
                "opt_state": tree_map(_host_copy, self.opt_state),
                "update_count": self.update_count,
            }

    def state_template(self) -> dict:
        """Shapes/dtypes of state_dict WITHOUT copying anything off the
        device (the restore template for checkpoint loading)."""

        def spec(t):
            return np.empty(tuple(t.shape), numpy_dtype(t.dtype))

        with self._state_lock:
            return {
                "params": tree_map(spec, self.params),
                "opt_state": tree_map(spec, self.opt_state),
                "update_count": 0,
            }

    def load_state_dict(self, state: dict) -> None:
        with self._state_lock:
            self.params = tree_map(self._on_device, state["params"])
            self.opt_state = tree_map(self._on_device, state["opt_state"])
            self.update_count = int(state.get("update_count", 0))

    def replace_params(self, params) -> None:
        """Swap the parameter tree, keeping the optimizer state (replica
        sync writes a group mean here); the state lock keeps a concurrent
        backward's update from interleaving."""
        with self._state_lock:
            self.params = tree_map(self._on_device, params)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    return np.array(tensor_to_numpy(t), copy=True)


def _flatten_params(params):
    """``(leaves, rebuild)`` of a parameter tree in the nest order."""
    structure = nested_structure(params)
    return nested_flatten(params), (
        lambda leaves: nested_pack(leaves, structure))
