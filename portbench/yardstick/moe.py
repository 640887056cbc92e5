"""Bytes and operations of a sparse-expert layer's grouped products: each
held expert's rows times its weight, every operand byte read once and every
output byte written once, fp32."""


def grouped_bytes_flops(rows: int, experts: int, k: int, n: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one grouped product: ``rows`` routed rows of K
    values in all, each through its expert's (K, N) weight; the weights of
    the ``experts`` held experts read once."""
    nbytes = 4 * (rows * k + experts * k * n + rows * n)
    return float(nbytes), float(2 * rows * k * n)


def experts_bytes_flops(rows: int, experts: int, d: int, f: int) -> tuple[float, float]:
    """(bytes, FLOPs) of the held experts' SwiGLU over ``rows`` routed rows:
    gate / up (D -> 2F) and down (F -> D)."""
    b1, f1 = grouped_bytes_flops(rows, experts, d, 2 * f)
    b2, f2 = grouped_bytes_flops(rows, experts, f, d)
    return b1 + b2, f1 + f2
