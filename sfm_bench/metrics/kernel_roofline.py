"""Per-layer metric `kernel_roofline`: the share of their least time at
which the port's seven CUDA kernels (B1-B7: ops/kernels.py,
ops/segment_ops.py, csrc/*.cu) ran in the traced window, in percent.

The least time of each launch is the larger of its bytes over the peak
bandwidth and its operations over the peak f32 rate (roofline.py, from
the launch's recorded shapes); its time is the kernel's interval in the
device trace, paired with the launch by order (one stream). The metric
is the sum of the least times over the sum of the times. A kernel that a
later change fuses away or replaces by a library call drops out of both
sums: that change needs the count of its work from the problem's shapes.
"""

from sfm_bench import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "recon_s"


def read(trace):
    """None without a known card, without launches, or where a kernel's
    launches and its trace intervals do not pair up."""
    if trace.peaks is None or not trace.launches:
        return None
    bw, flops = trace.peaks
    bound = dev = 0.0
    by_kernel = {}
    for name, shape in trace.launches:
        by_kernel.setdefault(name, []).append(shape)
    for name, shapes in by_kernel.items():
        times = trace.kernel_s.get(name, [])
        if len(times) != len(shapes):
            return None
        bound += sum(roofline.bound_s(name, s, bw, flops) for s in shapes)
        dev += sum(times)
    return 100.0 * bound / dev if dev > 0 else None
