"""Counter-based random numbers, bit for bit those of ``jax.random``.

The port's counterpart of the parts of ``jax.random`` that router jitter
(``ops/moe_dispatch.py``), sampled decoding (``models/transformer.py``
``generate``) and the deterministic-dropout expert (``models/layers.py``)
use: :func:`PRNGKey`, :func:`fold_in`, :func:`split`,
:func:`random_bits`, :func:`uniform`, :func:`bernoulli`, :func:`gumbel`
and :func:`categorical`, and the initialisers of the experts and the model trunks
(``lecun_normal`` and ``normal``, ``initializers.py``)
:func:`truncated_normal` and :func:`normal`, for
JAX's default generator
(``jax_default_prng_impl = "threefry2x32"``) with
``jax_threefry_partitionable = True``, the default of JAX 0.9.  With that
flag, element ``i`` (the row-major index) of a ``random_bits`` draw is
``y0 ^ y1`` of the Threefry-2x32 hash of the counter pair
``(i >> 32, i & 0xFFFFFFFF)`` under the key, so a draw does not depend on
how it is split over devices.

A key is an int64 tensor of shape [2] holding two uint32 words; a stack
of keys [*batch, 2] draws one array per key (``jax.vmap`` over keys),
of shape [*batch, *shape].  torch's
``uint32`` lacks most operations on both the CPU and CUDA, so the words
live in ``int64`` and every add and rotate is masked back to 32 bits:
the same code gives the same bits on both devices.  Every draw runs on
the device of the key it is given.

Everything up to :func:`uniform` is JAX's bit for bit.  :func:`gumbel`
takes two logarithms, each rounded once from f64 (the correctly rounded
value), where XLA's logarithm is within one f32 ulp of it: its noise is
within an ulp of JAX's at each logarithm, so :func:`categorical` picks
JAX's index except at a tie of that size.  :func:`truncated_normal`
follows XLA's f32 arithmetic on the CPU (its logarithms, ``log1p`` and
``erf_inv`` step by step, fused multiply-adds included): on the JAX
package's draws it is bit for bit JAX's at all but about one element in
10^5, and within 2 ulp there.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
# Threefry-2x32 (Salmon et al. 2011, 20 rounds) as jax._src.prng writes it
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the torch type that holds a draw of each bit width (signed above 8)
_BITS_TYPE = {8: torch.uint8, 16: torch.int16, 32: torch.int32}
# float dtype -> (bits, mantissa bits, the bits of 1.0); the two types
# whose draws are held bit for bit against JAX's on the CPU
_FLOAT_LAYOUT = {torch.float32: (32, 23, 0x3F800000),
                 torch.bfloat16: (16, 7, 0x3F80)}


def _word(value: int, name: str) -> int:
    if not 0 <= value <= _MASK:
        raise ValueError(f"{name} {value} is out of bounds for uint32")
    return value


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` (int64
    tensors of one shape, values in [0, 2^32)) under ``key``; returns the
    two output words, int64 in [0, 2^32).  A stack of keys [*batch, 2]
    hashes the counters under each key: outputs [*batch, *x0.shape]."""
    if key.dim() == 1:
        k0, k1 = (int(w) for w in key.tolist())
    else:  # one word per key, broadcast over the counters' dims
        lead = (...,) + (None,) * x0.dim()
        k0, k1 = key[..., 0][lead], key[..., 1][lead]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` with 32-bit JAX integers: the words
    ``(0, seed mod 2^32)``.  An integer tensor of seeds gives a stack of
    keys [*seed.shape, 2] on its device (``jax.vmap(PRNGKey)``)."""
    if isinstance(seed, torch.Tensor):
        low = seed.to(torch.int64) & _MASK
        return torch.stack([torch.zeros_like(low), low], dim=-1)
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)``.  ``data`` is a Python int in [0, 2^32) or an integer
    0-d tensor, whose value is taken mod 2^32 (JAX's cast of an int32
    to uint32)."""
    if isinstance(data, torch.Tensor):
        if data.dim() or data.is_floating_point():
            raise TypeError(f"fold_in data must be an integer scalar, got "
                            f"{data.dtype} of shape {tuple(data.shape)}")
        word = int(data) & _MASK
    else:
        word = _word(int(data), "fold_in data")
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key, zero, zero + word)
    return torch.cat([y0, y1])


# a draw of one key hashes at most this many counters at once: the hash
# holds a few int64 tensors of the chunk's size (a [256, 512, 2048] leaf
# whole would hold ~10 GB of them)
_CHUNK = 1 << 25


def _counters(key: torch.Tensor, shape: tuple[int, ...], start: int = 0,
              stop: int | None = None):
    """The Threefry-2x32 hash of the 64-bit row-major counters of an array
    of ``shape`` (those in ``[start, stop)``, flat), split into (high,
    low) words, as JAX's partitionable draws count."""
    size = 1
    for s in shape:
        size *= s
    i = torch.arange(start, size if stop is None else stop,
                     dtype=torch.int64, device=key.device)
    return threefry2x32(key, i >> 32, i & _MASK)


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``num`` (an int or a shape) new
    keys, [*shape, 2], key ``i`` the two words of the hash of counter
    ``i``."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    y0, y1 = _counters(key, shape)
    return torch.stack([y0, y1], dim=-1).reshape(*shape, 2)


def random_bits(key: torch.Tensor, bit_width: int,
                shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits`` of ``bit_width`` in 8, 16 or 32, as the signed
    torch type of that width holding the unsigned bits (uint8 for 8)."""
    if bit_width not in _BITS_TYPE:
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if key.dim() == 1 and size > _CHUNK:
        out = torch.empty(size, dtype=_BITS_TYPE[bit_width],
                          device=key.device)
        for start in range(0, size, _CHUNK):
            stop = min(start + _CHUNK, size)
            y0, y1 = _counters(key, shape, start, stop)
            out[start:stop] = _as_signed(
                (y0 ^ y1) & ((1 << bit_width) - 1), bit_width)
        return out.reshape(shape)
    y0, y1 = _counters(key, shape)
    bits = (y0 ^ y1) & ((1 << bit_width) - 1)
    return _as_signed(bits, bit_width).reshape(*key.shape[:-1], *shape)


def _as_signed(word: torch.Tensor, nbits: int) -> torch.Tensor:
    """int64 values in [0, 2^nbits) as the torch integer type of ``nbits``
    holding the same bits (uint8 for 8)."""
    if nbits > 8:
        word = word - ((word >> (nbits - 1)) << nbits)
    return word.to(_BITS_TYPE[nbits])


def uniform(key: torch.Tensor, shape: tuple[int, ...],
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: the top mantissa-width bits of a draw under
    the exponent of 1.0 give a float in [1, 2); minus 1, scaled to
    ``maxval - minval``, plus ``minval``, clamped below at ``minval``,
    each step rounded as XLA on the CPU rounds it."""
    _check_float("uniform", dtype)
    nbits, nmant, one = _FLOAT_LAYOUT[dtype]
    rng_bits = nbits if nmant >= 8 else 8  # bf16 draws 8 bits, as JAX does
    bits = random_bits(key, rng_bits, shape).to(torch.int64) & (
        (1 << rng_bits) - 1)
    word = (bits >> (rng_bits - nmant)) | one
    floats = _as_signed(word, nbits).view(dtype)
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    floats = floats - torch.ones((), dtype=dtype, device=key.device)
    if dtype == torch.float32:
        # XLA contracts the f32 scale-and-shift into one fused multiply-add
        # (one rounding); f64 holds the product exactly and, at jitter
        # widths, the sum too, so one rounding to f32 gives the same bits
        scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    else:  # bf16: rounded after each operation, as torch does
        scaled = floats * (hi - lo) + lo
    return torch.maximum(lo, scaled)


def bernoulli(key: torch.Tensor, p: float,
              shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``
    (JAX's f32): ``uniform(key, shape) < p``, bool."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)


def gumbel(key: torch.Tensor, shape: tuple[int, ...],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in its default mode "low":
    ``-log(-log(u))`` with ``u = uniform(key, minval=tiny)``, each
    logarithm rounded to ``dtype`` from f64."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny)
    inner = (-torch.log(u.double())).to(dtype)
    return (-torch.log(inner.double())).to(dtype)


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)`` (with replacement,
    one draw per distribution): ``argmax(logits + gumbel)`` along
    ``axis``, the gumbel noise of ``logits``' shape and dtype drawn on
    ``logits``' device; int64 indices of ``logits``' shape without
    ``axis``."""
    noise = gumbel(key.to(logits.device), tuple(logits.shape), logits.dtype)
    return torch.argmax(noise + logits, dim=axis)


# ---- truncated_normal: XLA's f32 arithmetic on the CPU, step by step ----


def _f32(value: float, device=None) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


# XLA contracts a multiply and an add into one fused multiply-add; f64
# holds the product of two f32 values exactly, so one rounding of the sum
# to f32 gives the fused result (but at a double-rounding tie)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (``b``, ``c``: f32 tensors or
    Python floats, taken as f32)."""
    def f64(v):
        if not isinstance(v, torch.Tensor):
            v = _f32(v, a.device)
        return v.double()
    return (a.double() * f64(b) + f64(c)).float()


# XLA's CPU logarithm (Cephes' single-precision log, as XLA emits it)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` on the CPU, for finite ``x > 0``."""
    bits = torch.clamp(x, min=torch.finfo(torch.float32).tiny).view(
        torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < 0.707106781186547524
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, -2.12194440e-4 * e)
    t = _fma(x2, -0.5, t) + y
    return _fma(e, 0.693359375, t)


# XLA's log1p below sqrt(2) - 1 in magnitude: Cephes' rational function
_LOG1P_NUM = (2.0039553499201281259648e1, 5.7112963590585538103336e1,
              6.0949667980987787057556e1, 2.9911919328553073277375e1,
              6.5787325942061044846969e0, 4.9854102823193375972212e-1,
              4.5270000862445199635215e-5)
_LOG1P_DEN = (6.0118660497603843919306e1, 2.1642788614495947685003e2,
              3.0909872225312059774938e2, 2.2176239823732856465394e2,
              8.3047565967967209469434e1, 1.5062909083469192043167e1, 1.0)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """The polynomial with ``coeffs`` (lowest degree first) at ``x``,
    Horner's rule in fused multiply-adds from the highest degree."""
    p = torch.full_like(x, float(_f32(coeffs[-1])))
    for c in reversed(coeffs[:-1]):
        p = _fma(p, x, c)
    return p


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` on the CPU, for finite ``x > -1``."""
    x2 = x * x
    ratio = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(x2, -0.5, (x * x2) * ratio)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _xla_log(x + 1.0))


# XLA's f32 erf_inv: Giles' single-precision approximation (2010),
# coefficients from the highest degree, for w = -log1p(-x^2) below 5 (in
# w - 2.5) and above (in sqrt(w) - 3)
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` on the CPU, for ``|x| <= 1``."""
    w = -_xla_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, _f32(_ERF_INV_LT5[i], x.device),
                           _f32(_ERF_INV_GT5[i], x.device))

    p = coeff(0)
    for i in range(1, len(_ERF_INV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _sqrt2_erf_inv(u: torch.Tensor) -> torch.Tensor:
    """``sqrt2 * erf_inv(u)`` in ``u``'s dtype as XLA on the CPU computes
    it: f32 step by step; bf16 through f32 (XLA's ``erf_inv`` upcasts
    bf16), rounded to bf16 before the product, which rounds again."""
    sqrt2 = _f32(math.sqrt(2.0)).to(u.device)
    if u.dtype == torch.float32:
        return sqrt2 * _xla_erf_inv(u)
    return sqrt2.to(u.dtype) * _xla_erf_inv(u.float()).to(u.dtype)


def _check_float(name: str, dtype: torch.dtype) -> None:
    if dtype not in _FLOAT_LAYOUT:
        raise TypeError(f"{name} takes {sorted(map(str, _FLOAT_LAYOUT))}, "
                        f"got {dtype}")


def normal(key: torch.Tensor, shape: tuple[int, ...],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt2 * erf_inv(u)``
    with ``u = uniform(key, minval=nextafter(-1, 0), maxval=1)`` (JAX's
    ``_normal_real``), on the key's device."""
    _check_float("normal", dtype)
    minus_one = torch.tensor(-1.0, dtype=dtype)
    lo = float(torch.nextafter(minus_one, torch.zeros((), dtype=dtype)))
    return _sqrt2_erf_inv(uniform(key, shape, dtype, minval=lo, maxval=1.0))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: tuple[int, ...],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, dtype)``:
    ``u = uniform(key, minval=erf(lower/sqrt2), maxval=erf(upper/sqrt2))``,
    then ``sqrt2 * erf_inv(u)`` clipped to the open interval, on the key's
    device.  After the draw only IEEE-rounded operations run (one torch
    operation each, none fused), so a CUDA key gives the CPU's values
    (``chip_smoke.py`` phase 14 holds a card draw to a CPU draw)."""
    _check_float("truncated_normal", dtype)
    dev = key.device
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype)
    # XLA's erf gives the correctly rounded value at +-2/sqrt2 (the tests
    # hold the draws against JAX's); in bf16 it runs in f32 and rounds
    def bound(v):
        x = float(torch.tensor(v, dtype=dtype) / sqrt2)
        return float(torch.tensor(math.erf(x), dtype=dtype))
    u = uniform(key, shape, dtype, minval=bound(lower), maxval=bound(upper))
    out = _sqrt2_erf_inv(u)
    lo = torch.nextafter(torch.tensor(lower, dtype=dtype),
                         torch.tensor(math.inf, dtype=dtype)).to(dev)
    hi = torch.nextafter(torch.tensor(upper, dtype=dtype),
                         torch.tensor(-math.inf, dtype=dtype)).to(dev)
    return torch.minimum(torch.maximum(out, lo), hi)
