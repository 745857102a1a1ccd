"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit).  A run prints the card's own power limit beside them
(``run.py``)."""

HBM_BYTES_PER_S = 3.35e12
