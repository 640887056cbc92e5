"""Bytes and operations of causal attention and of the paged decode
attention, each input byte read once and each output byte written once,
over the (query, key) pairs the causal mask leaves visible."""


def causal_attention_bytes_flops(b: int, s: int, h: int, kv: int, hd: int,
                                 itemsize: int, stats: bool = False) -> tuple[float, float]:
    """(bytes, FLOPs) of causal attention at a shape: q, k, v read once and
    the output written once; QK^T and PV over the S(S+1)/2 visible pairs per
    head, 2 FLOPs a multiply-add. ``stats`` adds the two (B, H, S) float32
    outputs (column means and last rows) of the statistics form."""
    pairs = s * (s + 1) / 2
    flops = 2 * 2 * b * h * pairs * hd
    nbytes = itemsize * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    if stats:
        nbytes += 2 * 4 * b * h * s
    return float(nbytes), float(flops)


def column_pass_bytes_flops(b: int, s: int, h: int, kv: int, hd: int,
                            itemsize: int) -> tuple[float, float]:
    """(bytes, FLOPs) of a column pass alone: q and K read once, the
    (B, H, S) float32 LSE read once, column sums and last rows written once;
    QK^T over the visible pairs."""
    flops = 2 * b * h * (s * (s + 1) / 2) * hd
    nbytes = itemsize * (b * s * h * hd + b * s * kv * hd) + 3 * 4 * b * h * s
    return float(nbytes), float(flops)


def paged_decode_bytes_flops(live_rows: int, slots: int, h: int, kv: int, hd: int,
                             itemsize: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one paged decode attention call over every slot:
    the ``live_rows`` K and V rows of all slots read once, q read and the
    output written once; QK^T and PV over each live row for every query
    head."""
    per_kv_head = h // kv
    nbytes = itemsize * (2 * live_rows * kv * hd + 2 * slots * h * hd)
    flops = 2 * 2 * live_rows * kv * per_kv_head * hd
    return float(nbytes), float(flops)
