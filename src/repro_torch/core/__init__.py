"""The WPFed protocol in PyTorch: LSH similarity, crowd-sourced ranking,
weighted neighbour selection, the all-in-one exchange, verification and
the announcement ledger, with the baselines and threat models it is
compared under. Counterpart of `repro.core`."""
from repro_torch.core.exchange import (  # noqa: F401
    ExchangeResult,
    all_in_one_exchange,
)
from repro_torch.core.rounds import (  # noqa: F401
    RoundProgram,
    Schedule,
    make_program,
    make_segment_fn,
    program_round,
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
    make_wpfed_round,
    select_phase,
    update_phase,
    wpfed_program,
)
from repro_torch.core.adversary import (  # noqa: F401
    Attack,
    ThreatModel,
    apply_attacks,
    attacker_mask_tail,
    instrument_program,
    resolve_attack,
    resolve_threat,
    threat_model,
)
