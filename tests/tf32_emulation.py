"""The tensor-core kernels' 3xTF32 arithmetic, emulated in float32 on the CPU
(a helper of the port's kernel tests, not a test module).

- ``tf32_round``: float32 -> TF32 as ``cvt.rna.tf32.f32`` (round to nearest,
  ties away from zero, to 10 explicit mantissa bits);
- ``split``: the 3xTF32 split ``a = hi + lo`` of ``csrc/tf32x3.cuh``;
- ``tc_product``: one product as the tensor cores run it, k8 steps in order,
  each ``lo_a hi_b + hi_a lo_b + hi_a hi_b``, summed in float32;
- ``tc_blocked_product``: a product over 64-row tiles, each tile's product
  from zero, a block's tiles added in float32 in order, the blocks' partials
  in double (``reduce_partials_kernel``);
- ``tc_product_small_first``: one product with the two small products of
  every k8 step first, then the large ones (the GLM kernels' order);
- ``tc_chunked_product``: ``tc_blocked_product`` over chunks of a given
  number of rows, each chunk's product in that order.
"""

import torch


def tf32_round(a):
    """float32 -> TF32 as ``cvt.rna.tf32.f32``: add half of the 13 dropped
    bits to the magnitude and clear them (ties away from zero)."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return bits.view(torch.float32)


def split(a):
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def tc_product(a, b, terms=3):
    """``a (M, K) @ b (K, N)`` as the tensor cores run it: k8 steps in order,
    each ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` (``terms=1``: ``hi_a hi_b``
    alone), accumulated in float32."""
    a_hi, a_lo = split(a.float())
    b_hi, b_lo = split(b.float())
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        if terms == 3:
            acc = acc + a_lo[:, s] @ b_hi[s]
            acc = acc + a_hi[:, s] @ b_lo[s]
        acc = acc + a_hi[:, s] @ b_hi[s]
    return acc


def tc_blocked_product(a, b, row_blocks, terms=3):
    """``a (M, R) @ b (R, N)`` over R in 64-row tiles: tile t belongs to block
    ``t % row_blocks``, each block sums its tiles in float32 in order, the
    blocks' partials are added in double (``reduce_partials_kernel``)."""
    n_tiles = -(-a.shape[1] // 64)
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
    for blk in range(row_blocks):
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
        for t in range(blk, n_tiles, row_blocks):
            s = slice(64 * t, 64 * t + 64)
            part = part + tc_product(a[:, s], b[s], terms)
        total = total + part.double()
    return total


def tc_product_small_first(a, b):
    """``a (M, K) @ b (K, N)``, K a multiple of 8: the two small products
    ``lo_a hi_b`` and ``hi_a lo_b`` of every k8 step first, then ``hi_a
    hi_b`` of every step, each step's sum taken exactly and rounded into one
    float32 accumulator."""
    a_hi, a_lo = split(a.float())
    b_hi, b_lo = split(b.float())
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    steps = [slice(k, k + 8) for k in range(0, a.shape[1], 8)]
    for s in steps:
        acc = (acc.double() + a_lo[:, s].double() @ b_hi[s].double()).float()
        acc = (acc.double() + a_hi[:, s].double() @ b_lo[s].double()).float()
    for s in steps:
        acc = (acc.double() + a_hi[:, s].double() @ b_hi[s].double()).float()
    return acc


def tc_chunked_product(a, b, row_blocks, chunk):
    """``a (M, R) @ b (R, N)`` over R in chunks of ``chunk`` rows (zeros past
    R): chunk k belongs to block ``k % row_blocks``, each chunk's product by
    ``tc_product_small_first`` from zero, a block's chunks added in float32 in
    order, the blocks' partials in double."""
    pad = (-a.shape[1]) % chunk
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    n_chunks = a.shape[1] // chunk
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
    for blk in range(row_blocks):
        part = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
        for k in range(blk, n_chunks, row_blocks):
            s = slice(chunk * k, chunk * k + chunk)
            part = part + tc_product_small_first(a[:, s], b[s])
        total = total + part.double()
    return total
