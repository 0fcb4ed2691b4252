"""``k3_roofline``: the share of its roofline that the K3 kernels
reach: the least time of the traced frames' K3 work (``reference.work``:
operations of the executed (pixel, row) evaluations, bytes of each input
read and output written once, at the published float32 and HBM peaks)
over the kernels' device time. The kernels are named in
``k3_roofline.json``."""

from _roofline import share
from harness.spec import metric_data

_DATA = metric_data(__file__)


def read(ctx):
    return share(ctx, _DATA["kernels"], _DATA["work"])
