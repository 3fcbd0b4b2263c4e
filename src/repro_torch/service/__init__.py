"""The continuous federation service. Counterpart of `repro.service`.

  membership.py  churn over a fixed padded client axis: ServiceState
                 (active mask, per-client code_age and gossip budget),
                 join / leave events, participation and degraded-round
                 masks
  transport.py   the bulletin-board link: checksummed announcements,
                 bounded-retry publish / fetch, deterministic fault
                 injection (core.faults.FaultPlan), longest-valid-chain
                 recovery
  driver.py      the continuous driver: one segment per period, host
                 sync, transport publish and checkpoint between periods;
                 resume_service restores bit for bit
  serving.py     PersonalizedServer, batched inference across the
                 per-client personalized models
"""
from repro_torch.core.faults import (  # noqa: F401  (the fault plan rides
    FaultPlan,                         # the service API)
    FaultTrace,
    parse_fault_spec,
)
from repro_torch.service.membership import (  # noqa: F401
    ChurnEvent,
    ServiceConfig,
    ServiceState,
    apply_events,
    init_service_state,
    join,
    leave,
    mask_stragglers,
    merge_delivery,
    parse_events,
    participation_mask,
    staleness_discount,
)
from repro_torch.service.transport import (  # noqa: F401
    BulletinTransport,
    LedgerRollbackError,
    RetryPolicy,
    TransportError,
    recover_chain,
)
from repro_torch.service.driver import (  # noqa: F401
    CrashInjected,
    checkpoint_num_clients,
    checkpoint_param_names,
    resume_service,
    run_service,
    service_program,
)
from repro_torch.service.serving import PersonalizedServer  # noqa: F401
