"""Share of its roofline that ``ops.gmm`` (the ``moe_gmm`` kernel)
reaches in the traced slice: ``cost.moe_gmm`` with each call's live
experts and filled rows read from its counts, over the device time of
the kernels inside its spans, in %."""
import cost


def read(rec):
    return cost.roofline(rec, "gmm", cost.moe_gmm)
