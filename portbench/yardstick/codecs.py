"""Bytes a per-token wire codec kernel must move at (N, D): each input read
once and each output written once."""


def codec_bytes(kernel: str, n: int, d: int, itemsize: int = 4) -> int:
    """K1 / K2 (int4 per token: D/2 bytes and one float32 scale a row, a
    float32 activation) and K3 / K4 (int8 affine per token: D bytes and two
    float32 words a row; K3 reads the hidden in its own dtype, ``itemsize``
    bytes an element, K4 writes float32)."""
    act = 4 * n * d
    return {"int4_encode": act + n * d // 2 + 4 * n,
            "int4_decode": act + n * d // 2 + 4 * n,
            "int8_affine_encode": itemsize * n * d + n * d + 8 * n,
            "int8_affine_decode": act + n * d + 8 * n}[kernel]
