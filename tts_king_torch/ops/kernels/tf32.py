"""The attention kernels' f32 products, emulated in plain PyTorch.

On the tensor cores the kernels (``csrc/attention_mma.cuh``) multiply f32
operands as 3xTF32: each operand x is split into hi, x rounded to TF32 (10
mantissa bits; to nearest, ties away from zero, as ``cvt.rna.tf32.f32``
rounds), and lo = x - hi, of which the tensor core reads the TF32 bits (the
low 13 dropped); a product adds lo*hi + hi*lo + hi*hi in f32.
``matmul_3xtf32`` computes the same products with three f32 matmuls, so the
CPU tests can hold the kernels' arithmetic against the plain versions and
the JAX package. Nothing on the port's path calls it.
"""

import torch

_LOW13 = 0x1FFF   # the mantissa bits TF32 drops


def split_tf32(x):
    """(hi, lo) of a float32 tensor: hi = x rounded to TF32, to nearest
    with ties away from zero; lo = x - hi truncated to TF32. Both have their
    low 13 bits zero, and hi + lo equals x to 2^-21 relative."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~_LOW13).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & ~_LOW13)
    return hi, lo.view(torch.float32)


def matmul_3xtf32(a, b):
    """a @ b for float32 tensors as the kernels compute it: three f32
    matmuls of the TF32 parts (each product of two TF32 values is exact in
    f32), the small terms first."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_hi, b_hi))
