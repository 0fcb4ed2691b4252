"""``capture_s``: the seconds ``render_animation`` took to capture the
cell's frame step as a CUDA graph (its ``info["capture_s"]``, the
program's own span), part of ``setup_s``."""


def read(ctx):
    v = ctx.info.get("capture_s")
    return float(v) if v else None
