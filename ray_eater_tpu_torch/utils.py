"""Small shared helpers (counterpart of ``ray_eater_tpu/utils/__init__.py``)."""


def pad_to(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (tile/chunk alignment)."""
    return ((x + m - 1) // m) * m
