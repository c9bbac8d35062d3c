"""uint32 hashing in int64 lanes, bitwise the JAX package's uint32 arithmetic.

PyTorch has ``torch.uint32`` but no ``>>`` for it on the CPU, so a uint32
value lives in an int64 tensor in ``[0, 2^32)``. A product of two 32-bit
values would overflow int64, so :func:`mul_u32` multiplies in 16-bit halves:
``x·k mod 2^32 = (lo·k + ((hi·k) mod 2^16)·2^16) mod 2^32`` with
``x = hi·2^16 + lo``, every term below 2^49.
"""
import torch

Tensor = torch.Tensor

MASK = 0xFFFFFFFF


def as_u32(x: Tensor) -> Tensor:
    """Integer (or bit-cast) values as uint32 lanes: two's complement wrap,
    as ``astype(jnp.uint32)`` of int32 gives."""
    return x.to(torch.int64) & MASK


def mul_u32(x: Tensor, k: int) -> Tensor:
    """``x·k mod 2^32`` for uint32 lanes ``x`` and a constant ``k < 2^32``."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * k + (((hi * k) & 0xFFFF) << 16)) & MASK


def mix_u32(x: Tensor) -> Tensor:
    """The splitmix32-style avalanche of JAX ``countmin._mix_u32`` and
    ``reservoir._mix_u32`` (the two are the same function)."""
    x = mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)
