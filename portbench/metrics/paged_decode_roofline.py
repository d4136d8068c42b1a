"""Share of its roofline that ``ops.paged_decode`` reaches in the traced
slice: the least time each call could take (``cost.paged_decode``:
the K/V of the positions it attends read once, at the data sheet's
peaks) summed over the calls, over the device time of the kernels
launched inside their spans, in %."""
import cost


def read(rec):
    return cost.roofline(rec, "paged_decode", cost.paged_decode)
