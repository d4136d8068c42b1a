"""The paper's contribution: the Dynamic Service Provision (DSP) model.

- ``types``      Job / Workload — the unit of MTC/HTC work
- ``policy``     resource-management policies (B, R, DR1/DR2 semantics)
- ``provision``  grant-or-reject provision service + lease billing
- ``lifecycle``  TRE state machine (CSF lifecycle management service)
- ``scheduling`` first-fit (HTC), FCFS (MTC) and conservative-backfill
                 job schedulers, pluggable via ``SCHEDULERS``
- ``tre``        the unified RuntimeEnv control plane: queue + trigger
                 monitor + policy negotiation + idle accounting, shared by
                 the emulator and the live controller through Clock/driver
                 protocols
- ``registry``   pluggable System registry: usage models register by name
"""
from repro_torch.core.lifecycle import LifecycleService, TREState  # noqa: F401
from repro_torch.core.policy import MgmtPolicy, PolicyEngine  # noqa: F401
from repro_torch.core.provision import ProvisionService  # noqa: F401
from repro_torch.core.registry import (  # noqa: F401
    System, available_systems, get_system, register_system,
)
from repro_torch.core.tre import (  # noqa: F401
    Clock, HTCRuntimeEnv, MTCRuntimeEnv, RuntimeEnv, TickClock,
)
from repro_torch.core.types import Job, Workload  # noqa: F401
