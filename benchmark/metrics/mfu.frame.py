"""``mfu.frame``: the whole frame's share of the card's peak: the least
time of the checked frames' work (``reference.work``: the projection of
every splat and every executed composite evaluation at the float32 peak,
or the scene read and the u8 image written once at the HBM peak, whichever
is longer) over the measured times of the same frames in the untraced
window."""

from reference.work import least_s


def read(ctx):
    if not ctx.checked:
        return None
    least = sum(least_s(w["frame"]["flops"], w["frame"]["bytes"])[0]
                for w, _ in ctx.checked)
    spent = sum(ms for _, ms in ctx.checked) / 1e3
    return 100.0 * least / spent if spent > 0 and least > 0 else None
