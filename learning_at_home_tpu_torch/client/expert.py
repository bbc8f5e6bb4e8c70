"""RemoteExpert: a network-remote expert that behaves like a local function.

The port of ``learning_at_home_tpu/client/expert.py``.  Contract from the
reference's ``hivemind/client/expert.py`` (SURVEY.md §2): the forward
serializes inputs and RPCs the server; a custom autograd Function makes
``backward`` issue a second RPC that returns input-gradients (and, as a
side effect, triggers the server's optimizer step).

Where the JAX package uses ``jax.custom_vjp`` over ``io_callback``, the
port uses :class:`_RemoteCall`, a ``torch.autograd.Function``: its forward
calls :meth:`RemoteExpert.forward_blocking` and its backward
:meth:`RemoteExpert.backward_blocking`, on host tensors (numpy on the
wire); results come back on the first input's device; integer inputs
(det_dropout's seed) take no gradient.  Output dtypes come from the
server's ``output_schema`` (one ``info`` RPC, cached).  Faults here RAISE
(single-expert semantics); k-of-n fault *tolerance* lives in
RemoteMixtureOfExperts.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from learning_at_home_tpu_torch.client.rpc import client_loop, pool_registry
from learning_at_home_tpu_torch.convert import (
    numpy_dtype,
    numpy_to_tensor,
    tensor_to_numpy,
)
from learning_at_home_tpu_torch.utils.connection import Endpoint
from learning_at_home_tpu_torch.utils.nested import nested_flatten

logger = logging.getLogger(__name__)


class RemoteExpert:
    """Stub for one expert hosted on a remote Server.

    Output dtypes and arity (the JAX client's io_callback specs) resolve
    in priority order:

    1. an explicit ``output_spec_fn(*inputs)`` returning one spec
       ``(shape, dtype)`` or a list of them, one per output;
    2. the server's published ``output_schema`` (per-row leaf shapes +
       dtypes, set once the expert has warmed up or served a forward) —
       fetched lazily with one ``info`` RPC and cached;
    3. fallback: one output of the first input's dtype.
    """

    def __init__(
        self,
        uid: str,
        endpoint: Endpoint,
        timeout: float = 30.0,
        output_spec_fn: Optional[Callable] = None,
        wire_dtype: Optional[str] = None,
    ):
        from learning_at_home_tpu_torch.utils.serialization import (
            validate_wire_dtype,
        )

        validate_wire_dtype(wire_dtype)
        # transport encoding: floating payloads downcast both ways (server
        # computes in f32 — see server/connection_handler.py); the blocking
        # calls RETURN wire-dtype arrays, the autograd path casts them to
        # the output dtypes
        self.wire_dtype = wire_dtype
        self.uid = uid
        self.endpoint = (endpoint[0], int(endpoint[1]))
        self.timeout = timeout
        self.output_spec_fn = output_spec_fn
        self._server_output_schema = ()  # () = not fetched yet; None = absent
        self._structure_checked = False

    # ---- blocking host-side RPCs (also used by the MoE layer) ----

    async def _rpc(self, msg_type, tensors, meta):
        pool = pool_registry().get(self.endpoint)
        return await pool.rpc(msg_type, tensors, meta, timeout=self.timeout)

    async def _rpc_prepared(self, msg_type, wire, meta):
        pool = pool_registry().get(self.endpoint)
        return await pool.rpc_prepared(msg_type, wire, meta, timeout=self.timeout)

    def _wire_cast(self, arrs) -> list:
        from learning_at_home_tpu_torch.utils.serialization import wire_cast

        return wire_cast(arrs, self.wire_dtype)

    def _wire_meta(self, meta: dict) -> dict:
        if self.wire_dtype is not None:
            meta["wire"] = self.wire_dtype
        return meta

    def _call_blocking(self, msg_type: str, tensors, meta: dict):
        """One exchange with serialization on THIS thread (pipelined
        mode), so the shared ``lah-client`` loop only writes ready
        buffers.  Legacy mode keeps the serialize-on-the-loop path (the
        bench A/B baseline)."""
        from learning_at_home_tpu_torch.client.rpc import dispatch_mode

        if dispatch_mode() == "pipelined":
            from learning_at_home_tpu_torch.utils.serialization import (
                WireTensors,
            )

            wire = WireTensors.prepare(tensors)
            out, _ = client_loop().run(self._rpc_prepared(msg_type, wire, meta))
        else:
            out, _ = client_loop().run(self._rpc(msg_type, tensors, meta))
        return out

    def forward_blocking(self, inputs: Sequence[np.ndarray]) -> list[np.ndarray]:
        return self._call_blocking(
            "forward", self._wire_cast(inputs),
            self._wire_meta({"uid": self.uid}),
        )

    def backward_blocking(
        self, inputs: Sequence[np.ndarray], grad_outputs: Sequence[np.ndarray]
    ) -> list[np.ndarray]:
        return self._call_blocking(
            "backward",
            self._wire_cast([*inputs, *grad_outputs]),
            self._wire_meta({"uid": self.uid, "n_inputs": len(inputs)}),
        )

    def info(self) -> dict:
        _, meta = client_loop().run(self._rpc("info", (), {"uid": self.uid}))
        return meta

    # ---- the autograd call path ----

    def _output_dtypes(self, inputs: Sequence[torch.Tensor]) -> list:
        """Numpy dtypes of the outputs, one per output (see the class
        docstring for the resolution order)."""
        if self.output_spec_fn is not None:
            spec = self.output_spec_fn(*inputs)
            specs = spec if isinstance(spec, list) else [spec]
            return [np.dtype(dtype) for _shape, dtype in specs]
        if self._server_output_schema == ():
            # cache ONLY a published schema; on RPC failure or a not-yet-
            # warmed server fall back for THIS call and re-fetch next time
            try:
                schema = self.info().get("output_schema")
            except Exception:
                logger.warning(
                    "info RPC for %s failed; falling back to "
                    "first-input-dtype output", self.uid, exc_info=True
                )
                schema = None
            if schema:
                self._server_output_schema = schema
        else:
            schema = self._server_output_schema
        if schema:
            return [np.dtype(s["dtype"]) for s in schema]
        return [numpy_dtype(inputs[0].dtype)]

    def __call__(self, *inputs):
        """Differentiable remote forward; backward RPCs on the vjp.

        Arguments may be nests of tensors — flattened to the wire's flat
        order (jax's), and on the first nested call the client checks its
        structure against the server's published ``input_schema`` so a
        flatten-order mismatch fails loudly instead of silently binding
        tensors to the wrong arguments."""
        leaves = nested_flatten(inputs)
        if len(leaves) != len(inputs) and not self._structure_checked:
            self._check_structure(inputs)
        dtypes = self._output_dtypes(leaves)
        # host tensors in and out of the autograd function: its backward
        # blocks on the network, and so must run on the thread that called
        # backward, not on autograd's worker thread for the card, which a
        # server in the same process needs for its own backward
        out = _RemoteCall.apply(self, dtypes, *(x.to("cpu") for x in leaves))
        out = tuple(o.to(leaves[0].device) for o in out)
        return out[0] if len(out) == 1 else out

    def _check_structure(self, inputs: tuple) -> None:
        from learning_at_home_tpu_torch.utils.nested import schema_from_tree

        server_schema = self.info().get("input_schema")
        if server_schema is not None:
            client_tree = inputs[0] if len(inputs) == 1 else tuple(inputs)
            client_schema = schema_from_tree(client_tree)
            if client_schema != server_schema:
                raise ValueError(
                    f"input structure mismatch for expert {self.uid}: "
                    f"client sends {client_schema}, server expects "
                    f"{server_schema} — tensors would bind to the wrong "
                    "arguments"
                )
        self._structure_checked = True

    def __repr__(self) -> str:
        return f"RemoteExpert({self.uid!r} @ {self.endpoint[0]}:{self.endpoint[1]})"


class _RemoteCall(torch.autograd.Function):
    """``forward_blocking`` as the primal and ``backward_blocking`` as its
    vjp.  The backward ships ALL inputs (the server re-forwards them) and
    returns grads only for the floating ones."""

    @staticmethod
    def forward(ctx, expert: RemoteExpert, dtypes: list, *inputs):
        arrs = [tensor_to_numpy(x) for x in inputs]
        outs = expert.forward_blocking(arrs)
        if len(outs) != len(dtypes):
            raise ValueError(
                f"expert {expert.uid} returned {len(outs)} outputs, "
                f"client expected {len(dtypes)}"
            )
        device = inputs[0].device
        ctx.expert = expert
        ctx.save_for_backward(*inputs)
        return tuple(numpy_to_tensor(np.asarray(o, dtype=d), device)
                     for o, d in zip(outs, dtypes))

    @staticmethod
    def backward(ctx, *grad_outputs):
        inputs = ctx.saved_tensors
        expert = ctx.expert
        grads = expert.backward_blocking(
            [tensor_to_numpy(x) for x in inputs],
            [tensor_to_numpy(g) for g in grad_outputs],
        )
        if len(grads) != len(inputs):
            raise ValueError(
                f"expert {expert.uid} returned {len(grads)} input-grads "
                f"for {len(inputs)} inputs"
            )
        out = [
            numpy_to_tensor(np.asarray(g, dtype=numpy_dtype(x.dtype)),
                            x.device)
            if x.is_floating_point() else None
            for x, g in zip(inputs, grads)
        ]
        return (None, None, *out)
