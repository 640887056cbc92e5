"""Command-line tools of the port: the codec and fused-hop probes
(``pallas_probe``, whose fused-hop rows feed the fused-hop gate) and the
attention probe against SDPA (``attn_probe``)."""
