"""The WPFed protocol in PyTorch: LSH similarity, crowd-sourced ranking,
weighted neighbour selection, the all-in-one exchange, verification and
the announcement ledger. Counterpart of `repro.core`."""
from repro_torch.core.exchange import (  # noqa: F401
    ExchangeResult,
    all_in_one_exchange,
)
from repro_torch.core.rounds import (  # noqa: F401
    RoundProgram,
    Schedule,
    resolve_schedule,
    run_rounds,
)
from repro_torch.core.protocol import (  # noqa: F401
    Announcement,
    FedState,
    SelectResult,
    announce_phase,
    evaluate,
    exchange_phase,
    init_state,
    select_phase,
    update_phase,
    wpfed_program,
)
