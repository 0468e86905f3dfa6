"""The accuracy loop's entry points, counterparts of the JAX package's
`tools/` of the same names: each runs as `python -m
sam6d_tpu_torch.tools.<name>`, on the card unless `--device cpu`."""
