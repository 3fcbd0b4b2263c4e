"""Seeded-leak fixture: `taint-sink` — an announcement that publishes a
RAW PARAMETER row to the chain. The codes and the commitment are
properly declassified; the third field is a slice of the client's own
parameters, the refactor regression the trust-free check exists to
catch. Twin of `tests/analysis_fixtures/leak_announce_field.py`."""
import torch

from repro_torch.analysis.privacy import sink
from repro_torch.analysis.taint import SRC_PARAMS, taint_target
from repro_torch.core.chain import fnv1a_commit
from repro_torch.core.lsh import stacked_lsh_codes


def leaky_announce(params_vec):
    # stacked_lsh_codes / fnv1a_commit are registered declassifiers:
    # these two fields are fine
    codes = stacked_lsh_codes({"w": params_vec}, seed=1, bits=32)
    commit = fnv1a_commit(params_vec.to(torch.int32), salt=0)
    # BUG: the third announced field is the raw parameter row itself
    return sink("chain-announcement", (codes, commit, params_vec[0]))


taint_target(
    name="leak-announce-field",
    build=lambda: (leaky_announce,
                   (torch.ones((4, 8), dtype=torch.float32),),
                   (SRC_PARAMS,)))
