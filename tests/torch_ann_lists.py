"""Per-row ANN candidate lists that no bucket layout gives, for the
per-row selection's tests on the CPU (`test_torch_ann_slots.py`) and on
the card (`test_torch_cuda.py`). numpy only, so either side can import
it."""
import numpy as np


def arbitrary_lists(m, k, seed):
    """(M, K) int32 ids in [0, M] (M the sentinel): a quarter of the
    positions sentinels scattered between valid ids, the row's own id at
    a random position, a repeated id in every row, row 3 all sentinels
    and row 5 the id 7 at every position (M > 7)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, m, size=(m, k))
    ids[rs.rand(m, k) < 0.25] = m
    rows = np.arange(m)
    ids[rows, rs.randint(0, k, m)] = rows
    ids[rows, rs.randint(0, k, m)] = ids[rows, rs.randint(0, k, m)]
    ids[3] = m
    ids[5] = 7
    return ids.astype(np.int32)
