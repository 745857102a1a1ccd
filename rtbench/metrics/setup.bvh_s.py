"""Seconds of the set-up span ``setup.bvh_s`` (``rtbench/port.py`` ``Port``:
the scene's tables and the SBVH, built or loaded from the cache)."""


def read(rec: dict):
    return rec["spans"].get("setup.bvh_s")
