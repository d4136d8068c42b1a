"""MTC serving on the card: the continuous-batching ``Engine``, the
trace-rate driver and the multi-tenant fleet above it.

The control plane (``driver``, ``fleet``, ``columnar``, ``tenant``,
``paged``) is the port's own copy of ``repro.serve``'s, with
``TorchEngineAdapter`` in place of the JAX engine's adapter: it drives
``Engine`` on whatever device the engine was built for.
"""
from repro_torch.serve.columnar import (  # noqa: F401
    ColumnarEngine, ColumnarEnv, ColumnarServeDriver,
)
from repro_torch.serve.driver import (  # noqa: F401
    EmulatedEngine, ServeDriver, ServeInvariantError, ServeStats,
    TorchEngineAdapter,
)
from repro_torch.serve.engine import Engine, Request  # noqa: F401
from repro_torch.serve.fleet import (  # noqa: F401
    FleetStats, PartitionedEngine, ServeFleet, TenantSlice,
)
from repro_torch.serve.paged import PagedKVAllocator, pages_for  # noqa: F401
