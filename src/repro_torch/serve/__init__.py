"""MTC serving on the card: the continuous-batching ``Engine`` and the
paged-KV ledger it allocates from."""
from repro_torch.serve.engine import Engine, Request  # noqa: F401
from repro_torch.serve.paged import (  # noqa: F401
    PagedKVAllocator, ServeInvariantError, pages_for,
)
