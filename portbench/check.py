"""The comparison that decides `correct`.

The reference (`portbench/reference/`) replays the rounds that set-up
drove through the port's own round engine (the first reselection
periods, at least `check_rounds` rounds) and the window's last period,
from the inputs the benchmark made: the weights and data are
regenerated from the seed after the window. It follows the port round
by round: round 0 starts from the benchmark's weights and zero Adam
state (the "start" check holds the port's round-0 state to them), each
later round, and the window's last period, from the port's parameters,
Adam moments, codes, rankings and commitments after the round before
(within a gossip period of the window, from its own). Adam turns a gradient that is zero but for rounding into a step
of lr either way, so two sound runs part by up to 2 lr an element a
step; following the port keeps that from compounding. Within a round
the reference's logits, losses, gradients, moments and parameters are
its own. Its discrete decisions are checked against the port's and
then taken from it, so that one decision within rounding of a tie does
not fork the two: a code bit whose f64 projection of the port's own new
parameters lies within `CODE_MARGIN` of their norm of zero, and an
order of two l_ij or KL values within `DECISION_TOL` (relative, with an
absolute floor of the same), may go either way; any other difference
counts.

Numbers compared, each with its limit:
  start         round-0 state: weights, Adam state, codes, rankings,
                commitments (mismatches; 0)
  select        partner ids, Eq. 7 scores and the honest-reporter share
                of each global round (mismatches; 0)
  exchange      rows whose §3.5 kept set is not the lower-KL half of the
                selected (0)
  announce      code bits, ranking rows out of l_ij order or not the
                selected ids, commitments that are not FNV-1a of the
                ranking (0)
  chain         broken blocks, published announcements unlike the state
                they came from (set-up's periods, the window's last,
                the run's last), a failed `verify_chain` (0)
  loss_gap, ref_loss_gap, nbr_loss_gap
                relative gaps of the round's mean combined loss, mean
                distillation loss (the targets) and mean l_ij (the
                exchange's losses), worst round
  update_gap, moment_gap
                worst leaf's gap between the norms of the round's
                parameter change (and of Adam's first moment after it),
                over the larger of that leaf's reference norm and the
                median leaf's, worst round; leaves whose moment is under
                a thousandth of the median leaf's are left out
  param_gap     worst leaf's norm of (reference minus port) after a
                round over the norm of its change in the round (or the
                median leaf's, if larger), worst round after round 0
The last six take their limits from `cells/<cell>.json`.
"""
from __future__ import annotations

import statistics
from typing import Any, Dict

import torch

from portbench import inputs
from portbench.reference import chain as ref_chain
from portbench.reference import protocol as ref

CODE_MARGIN = 1e-5
DECISION_TOL = 1e-4
ROWS = 256                  # clients of one batched reference call
GAPS = ("loss_gap", "ref_loss_gap", "nbr_loss_gap", "update_gap",
        "moment_gap", "param_gap")
EXACT = ("start", "select", "exchange", "announce", "chain")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _tol(x: torch.Tensor) -> torch.Tensor:
    return DECISION_TOL * torch.clamp(x.abs(), min=1.0)


def code_mismatches(codes_prog: torch.Tensor, sums: torch.Tensor,
                    norms: torch.Tensor, margin: float) -> int:
    """Bits of the port's codes that differ from the sign of the f64
    sums, outside `margin` times the parameters' norm."""
    prog = ref.unpack(codes_prog.to(sums.device))
    want = sums > 0
    loose = sums.abs() <= margin * norms[:, None]
    return int(((prog != want) & ~loose).sum())


def mask_violations(kept: torch.Tensor, sel: torch.Tensor,
                    kl: torch.Tensor) -> int:
    """Rows whose kept set is not (up to DECISION_TOL) the (n + 1) // 2
    smallest KLs of the selected slots."""
    keep = (sel.sum(-1) + 1) // 2
    bad = (kept & ~sel).any(-1) | (kept.sum(-1) != keep)
    worst_kept = torch.where(kept, kl, -torch.inf).amax(-1)
    best_dropped = torch.where(sel & ~kept, kl, torch.inf).amin(-1)
    bad |= worst_kept > best_dropped + _tol(best_dropped.nan_to_num(
        posinf=0.0))
    return int(bad.sum())


def ranking_violations(ranking: torch.Tensor, ids: torch.Tensor,
                       valid: torch.Tensor, l_ij: torch.Tensor) -> int:
    """Rows whose ranking is not the `valid` (the selected) ids in
    ascending l_ij (up to DECISION_TOL) followed by -1s."""
    slot = ref.slot_of(ids, ranking)
    present = ranking >= 0
    n_valid = valid.sum(-1)
    bad = (present & (slot < 0)).any(-1)
    bad |= present.sum(-1) != n_valid
    bad |= (present[:, 1:] & ~present[:, :-1]).any(-1)      # -1s trail
    s = slot.clamp(min=0)
    bad |= (present & ~torch.gather(valid, 1, s)).any(-1)
    l = torch.gather(l_ij, 1, s)
    pairs = present[:, 1:]
    bad |= (pairs & (l[:, :-1] > l[:, 1:] + _tol(l[:, 1:]))).any(-1)
    return int(bad.sum())


def leaf_gap(prog: Dict[str, float], want: Dict[str, float],
             skip=()) -> float:
    keys = [k for k in want if k not in skip]
    med = statistics.median(want[k] for k in keys)
    return max(abs(prog[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def run_check(cfg: Dict, traffic: Dict, seed: int, obs: Dict[str, Any],
              limits: Dict[str, float], device,
              log=print) -> Dict[str, Dict[str, float]]:
    """Replay obs["rounds"]' rounds with the reference and compare.
    Returns {name: {"value", "limit"}} in a fixed order."""
    model, proto = cfg["model"], cfg["protocol"]
    kind, m = model["kind"], traffic["clients"]
    g_every = traffic["reselect_every"]
    n = min(proto["num_neighbors"], m - 1)
    bits = proto["lsh_bits"]
    dedupe = traffic["ref_mode"] == "public"
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count = dict.fromkeys(EXACT, 0)
    gaps = dict.fromkeys(GAPS, 0.0)

    params = inputs.make_weights(model, m, seed, dev)
    data = inputs.make_data(cfg, m, seed, dev)
    init = obs["init"]
    for k, v in params.items():
        v64 = v.to(torch.float64)
        if (float(v64.sum()), float((v64 * v64).sum())) != \
                tuple(init["fingerprint"][k]):
            count["start"] += 1
    count["start"] += int(init["opt_abs"] != 0.0)
    sums, norms = ref.lsh_sums(params, 0, bits)
    count["start"] += code_mismatches(init["codes"], sums, norms,
                                      CODE_MARGIN)
    count["start"] += int((init["rankings"] != -1).sum())
    count["start"] += int((init["commitments"].to(torch.int64)
                           != ref.fnv1a(init["rankings"])).sum())

    mo = {k: torch.zeros_like(v) for k, v in params.items()}
    vo = {k: torch.zeros_like(v) for k, v in params.items()}
    codes = init["codes"].to(dev)
    rankings = init["rankings"].to(dev)
    commits = init["commitments"].to(dev).to(torch.int64)
    table = ref.lut(codes.shape[1] * 32, bits, proto["gamma"], dev)
    use_ann = traffic["backend"] == "ann" or (
        traffic["backend"] == "auto" and ref.ann_route(
            m, codes.shape[1] * 32, proto["ann_prefix_bits"],
            proto["ann_probes"], n))
    n_local = data["x_train"].shape[1]
    mb = min(proto["local_batch"], n_local)
    ids = sel = None
    # set-up's rounds from round 0, then the window's last period from
    # the port's state before it; a round with no state after it (inside
    # a gossip period of the window) goes on from the reference's own
    win = obs.get("window")
    stretch = [(rec, after, None) for rec, after in
               zip(obs["rounds"], obs["states"])]
    if win is not None:
        afters = [None] * (len(win["rounds"]) - 1) + [win["after"]]
        stretch += [(rec, after, win["before"] if i == 0 else None)
                    for i, (rec, after) in enumerate(zip(win["rounds"],
                                                         afters))]
    for rec, after, start in stretch:
        if start is not None:
            params = {k: v.to(dev) for k, v in start["params"].items()}
            mo = {k: v.to(dev) for k, v in start["m"].items()}
            vo = {k: v.to(dev) for k, v in start["v"].items()}
            codes = start["codes"].to(dev)
            rankings = start["rankings"].to(dev)
            commits = start["commitments"].to(dev).to(torch.int64)
        r = rec["round"]
        prog_ids = torch.tensor(rec["ids"], dtype=torch.int32, device=dev)
        if r % g_every == 0:
            reporter = ref.fnv1a(rankings) == commits
            scores = ref.ranking_scores(rankings, reporter, m,
                                        proto["top_k"], dedupe)
            if use_ann:
                cand = ref.ann_candidates(codes, scores, r,
                                          proto["ann_prefix_bits"],
                                          proto["ann_probes"], n)
                want_ids, tw = ref.select_ann(codes, scores, table, n, cand)
            else:
                want_ids, tw = ref.select_exact(codes, scores, table, n)
            count["select"] += int((prog_ids != want_ids).sum())
            prog_scores = torch.tensor(rec["scores"], device=dev)
            count["select"] += int((prog_scores != scores).sum())
            count["select"] += int(rec["honest"] != float(
                reporter.to(torch.float32).mean()))
            ids, sel = prog_ids, torch.isfinite(tw)
        ex = ref.exchange(kind, params, data, ids, traffic["ref_mode"],
                          ROWS)
        kept = torch.tensor(rec["valid"], dtype=torch.bool, device=dev)
        count["exchange"] += mask_violations(kept, sel, ex.kl)
        nsel = sel.to(torch.float32).sum()
        nbr = float(torch.where(sel, ex.l_ij, 0.0).sum() / nsel.clamp(min=1))
        gaps["nbr_loss_gap"] = max(gaps["nbr_loss_gap"],
                                   _rel(rec["mean_neighbor_loss"], nbr))
        target, has = ref.targets(ex.web, kept)
        x_ref = data["x_ref"]
        if traffic["ref_mode"] == "public":
            x_ref = x_ref[0][None].expand(m, *x_ref.shape[1:])
        l_ij = ex.l_ij
        del ex
        batch = ref.draw_batches(seed, r, m, proto["local_steps"], n_local,
                                 mb).to(dev)
        new_p, mo, vo, losses = ref.local_update(
            kind, proto, params, mo, vo, r * proto["local_steps"],
            data["x_train"], data["y_train"], x_ref, target, has, batch,
            ROWS)
        mean = losses.mean(0)
        gaps["loss_gap"] = max(gaps["loss_gap"],
                               _rel(rec["mean_loss"], float(mean[0])))
        gaps["ref_loss_gap"] = max(gaps["ref_loss_gap"],
                                   _rel(rec["mean_ref_loss"], float(mean[2])))
        if after is None:
            params = new_p
            continue
        port = {k: v.to(dev) for k, v in after["params"].items()}
        if r % g_every == 0:
            # the codes hash the port's own new parameters
            sums, norms = ref.lsh_sums(port, r + 1, bits)
            count["announce"] += code_mismatches(after["codes"], sums, norms,
                                                 CODE_MARGIN)
            del sums
            ranking = after["rankings"].to(dev)
            count["announce"] += ranking_violations(ranking, ids, sel, l_ij)
            count["announce"] += int((ref.fnv1a(ranking) != after[
                "commitments"].to(dev).to(torch.int64)).sum())
        dp = ref.leaf_norms({k: new_p[k] - params[k] for k in params})
        dp_port = ref.leaf_norms({k: port[k] - params[k] for k in params})
        mn = ref.leaf_norms(mo)
        mn_port = ref.leaf_norms(after["m"])
        med = statistics.median(mn.values())
        skip = {k for k, v in mn.items() if v < 1e-3 * med}
        gaps["update_gap"] = max(gaps["update_gap"],
                                 leaf_gap(dp_port, dp, skip))
        gaps["moment_gap"] = max(gaps["moment_gap"],
                                 leaf_gap(mn_port, mn, skip))
        drift = ref.leaf_norms({k: new_p[k] - port[k] for k in params})
        floor = statistics.median(v for k, v in dp.items() if k not in skip)
        drift = max(drift[k] / max(dp[k], floor, 1e-30)
                    for k in params if k not in skip)
        if r > 0:   # round 0's first Adam step moves each element by lr
            # times the sign of its gradient, so one whose gradient is 0
            # but for rounding moves lr either way: logged, not compared
            gaps["param_gap"] = max(gaps["param_gap"], drift)
        log({"round": r, "param_gap": drift, "left_out": sorted(skip)})
        # follow the port: the next round starts from its state
        params = port
        mo = {k: v.to(dev) for k, v in after["m"].items()}
        vo = {k: v.to(dev) for k, v in after["v"].items()}
        codes = after["codes"].to(dev)
        rankings = after["rankings"].to(dev)
        commits = after["commitments"].to(dev).to(torch.int64)
        del new_p
    count["chain"] = chain_mismatches(obs)
    out = {k: {"value": count[k], "limit": 0} for k in EXACT}
    out.update({k: {"value": gaps[k], "limit": limits[k]} for k in GAPS})
    return out


def chain_mismatches(obs: Dict[str, Any]) -> int:
    blocks = obs["chain"]
    bad = ref_chain.check_blocks(blocks) + int(not obs["chain_verified"])
    rounds = [b["payload"].get("round") for b in blocks[1:]]
    bad += int(rounds != obs["chain_rounds"])
    g = obs["chain_rounds"][1] - 1 if len(obs["chain_rounds"]) > 1 else 1
    for per, blk in zip(obs["states"][g - 1::g], blocks[1:]):
        bad += ref_chain.check_announcements(
            blk["payload"], per["codes"].numpy(), per["rankings"].numpy())
    bad += ref_chain.check_announcements(
        blocks[-1]["payload"], obs["final"]["codes"].numpy(),
        obs["final"]["rankings"].numpy())
    win = obs.get("window")
    if win is not None:            # the window's last period's block
        blk = [b for b in blocks[1:]
               if b["payload"].get("round") == win["first_round"] + 1]
        bad += int(len(blk) != 1)
        for b in blk:
            bad += ref_chain.check_announcements(
                b["payload"], win["after"]["codes"].numpy(),
                win["after"]["rankings"].numpy())
    return bad
