"""Block-cyclic reduction's factorization, frozen from
``utils/roofline.py:128-149`` (``bcr_counts``): per level of ``no`` odd and
``ne`` even blocks, each odd block a Cholesky (B^3/3), the inverse from it
(2B^3/3), V L and V U (2B^3 each); each even block six (B, B) products;
the root's inversion.  Bytes: the bands read once (3mB^2) and A, C, V, VL,
VU and the root written once, f32."""

from .peaks import bound_s


def lattice_blocks(Nx, Ny):
    """``(m, B)`` of the P2 slope's lattice: two node rows of ``2 Nx + 1``
    nodes and 2 components a block, ``m`` block rows over ``2 Ny + 1`` node
    rows (the last may be half padding), as ``parallel/bcr.py:94-95``
    blocks it."""
    return (2 * Ny + 2) // 2, 2 * 2 * (2 * Nx + 1)


def factor_counts(m, B):
    """(operations, bytes) of one factorization."""
    bands, ops, blocks = 3 * m, 0, 0
    while m > 1:
        no, ne = m // 2, m - m // 2
        ops += (5 * no + 12 * ne) * B ** 3
        blocks += 2 * ne + 3 * no
        m = ne
    ops += B ** 3
    blocks += 1
    return ops, 4 * B * B * (bands + blocks)


def factor_bound_s(m, B):
    return bound_s(*factor_counts(m, B))
