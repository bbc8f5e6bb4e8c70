"""Counter-based random numbers, bit for bit those of ``jax.random``.

The port's counterpart of the parts of ``jax.random`` that router jitter
(``ops/moe_dispatch.py``) and sampled decoding (``models/transformer.py``
``generate``) use: :func:`PRNGKey`, :func:`fold_in`, :func:`split`,
:func:`random_bits`, :func:`uniform`, :func:`gumbel` and
:func:`categorical`, for JAX's default generator
(``jax_default_prng_impl = "threefry2x32"``) with
``jax_threefry_partitionable = True``, the default of JAX 0.9.  With that
flag, element ``i`` (the row-major index) of a ``random_bits`` draw is
``y0 ^ y1`` of the Threefry-2x32 hash of the counter pair
``(i >> 32, i & 0xFFFFFFFF)`` under the key, so a draw does not depend on
how it is split over devices.

A key is an int64 tensor of shape [2] holding two uint32 words.  torch's
``uint32`` lacks most operations on both the CPU and CUDA, so the words
live in ``int64`` and every add and rotate is masked back to 32 bits:
the same code gives the same bits on both devices.  Every draw runs on
the device of the key it is given.

Everything up to :func:`uniform` is JAX's bit for bit.  :func:`gumbel`
takes two logarithms, each rounded once from f64 (the correctly rounded
value), where XLA's logarithm is within one f32 ulp of it: its noise is
within an ulp of JAX's at each logarithm, so :func:`categorical` picks
JAX's index except at a tie of that size.
"""

from __future__ import annotations

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
    two output words, int64 in [0, 2^32)."""
    k0, k1 = (int(w) for w in key.tolist())
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


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` with 32-bit JAX integers: the words
    ``(0, seed mod 2^32)``."""
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


def _counters(key: torch.Tensor, shape: tuple[int, ...]):
    """The Threefry-2x32 hash of the 64-bit row-major counters of an array
    of ``shape``, split into (high, low) words, as JAX's partitionable
    draws count."""
    size = 1
    for s in shape:
        size *= s
    i = torch.arange(size, dtype=torch.int64, device=key.device)
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
    y0, y1 = _counters(key, shape)
    bits = (y0 ^ y1) & ((1 << bit_width) - 1)
    return _as_signed(bits, bit_width).reshape(shape)


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
    if dtype not in _FLOAT_LAYOUT:
        raise TypeError(f"uniform takes {sorted(map(str, _FLOAT_LAYOUT))}, "
                        f"got {dtype}")
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
