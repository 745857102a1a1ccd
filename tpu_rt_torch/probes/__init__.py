"""Probes: fixed-trip kernels that time one piece of a traversal kernel on
the card, the counterparts of ``tpu_rt``'s ``tools/`` ablations."""
