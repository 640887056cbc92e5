"""Command-line tools of the port: the codec and fused-hop probes
(``pallas_probe``, whose fused-hop rows feed the fused-hop gate), the
attention probe against SDPA (``attn_probe``), the ring's local-mode gap
(``ring_mode_gap``), the window-batch memory preflight (``wb_preflight``),
reference-exact corpus tokenization (``prepare_wikitext``) and the
golden-anchor checker (``check_reproduction``)."""
