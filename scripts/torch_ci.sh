#!/usr/bin/env bash
# One-command check of the PyTorch port (the counterpart of
# scripts/ci.sh), in ci.sh's order: the port's analysis gate (kernel
# contracts, host-sync lint, privacy taint; strict) first, since it is
# cheap and catches the kernel-contract and disclosure bugs before the
# tests spend minutes; each seeded-leak fixture must then FAIL the strict
# gate (a checker that stops flagging planted leaks is itself broken);
# then the tests; then the smoke twins: tiled kernels past the one-shot
# shared-memory budget, the ANN selection at M = 16,384, the continuous
# service's churned kill/resume, the chaos soak and the attack-resilience
# example at CI size; last the federation dry run.
#
# On the card (the default) every step launches the CUDA kernels; the
# tests are the card's own (tests/test_torch_cuda.py: that machine has
# no JAX, so the files that hold the port against the JAX package do not
# import there) and the dry run has 1,024 clients, public and tiled, as
# ci.sh's. With `--device cpu` every step takes the plain versions, the
# tests are the port's CPU tests (tests/test_torch_*.py, held against the
# JAX package; the card's tests skip), and the dry run has 16 clients
# (tests/test_torch_fed_dryrun.py's size): 1,024 reduced-phi3 clients
# take the CPU far too long. The tiled smoke is left out on the CPU: its
# selection at M = 65,536 (the first power of two past the one-shot
# kernel's shared memory) is held against the plain version in 256 tiles
# of 4,096 x 4,096, and 4 such tiles took 31 s on 4 CPU threads.
#
# ci.sh's kernel micro-benchmark step (benchmarks/kernel_micro.py) has no
# counterpart here yet: the port's benchmark comes in a change of its
# own.
#
# Usage: scripts/torch_ci.sh [--device cpu] [extra pytest args]
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

DEVICE=cuda
if [[ "${1:-}" == "--device" ]]; then
    DEVICE="${2:?--device needs a value (cpu or cuda)}"
    shift 2
fi
case "$DEVICE" in
    cuda) DEV_ARGS=() ;;
    cpu) DEV_ARGS=(--device cpu) ;;
    *) echo "unknown device $DEVICE (cpu or cuda)"; exit 2 ;;
esac
OUT=build/torch_ci
mkdir -p "$OUT"
step() { echo "== $* =="; STEP_T0=$SECONDS; }
done_step() { echo "-- $((SECONDS - STEP_T0)) s"; }

step "static analysis: contracts + lint + privacy taint (strict, $DEVICE)"
python -m repro_torch.analysis --strict --device "$DEVICE" \
    --json "$OUT/ANALYSIS_report.json"
done_step

step "seeded-leak fixtures must fail the strict gate"
for leak in tests/torch_analysis_fixtures/leak_*.py; do
    if out=$(python -m repro_torch.analysis --strict --device "$DEVICE" \
             "$leak" 2>&1); then
        echo "FATAL: $leak passed the strict gate (planted leak missed)"
        exit 1
    fi
    if ! grep -q "finding(s)" <<<"$out"; then
        echo "FATAL: the gate did not run on $leak:"
        echo "$out"
        exit 1
    fi
    echo "ok: $leak rejected"
done
done_step

if [[ "$DEVICE" == cpu ]]; then
    step "the port's tests, against the JAX package (CPU)"
    python -m pytest -x -q tests/test_torch_*.py "$@"
else
    step "the port's card tests"
    python -m pytest -x -q --noconftest tests/test_torch_cuda.py "$@"
fi
done_step

if [[ "$DEVICE" == cpu ]]; then
    echo "== tiled kernels: left out on the CPU (tests/test_torch_examples.py"
    echo "   holds the twin's checks at M = 2,048) =="
else
    step "tiled kernels beyond the one-shot shared-memory budget (smoke)"
    python scripts/torch_tiled_smoke.py
    done_step
fi

step "sub-quadratic ANN selection smoke"
python scripts/torch_ann_smoke.py ${DEV_ARGS[@]+"${DEV_ARGS[@]}"}
done_step

step "continuous federation service: churn + kill/resume"
python scripts/torch_service_smoke.py ${DEV_ARGS[@]+"${DEV_ARGS[@]}"}
done_step

step "chaos soak: faults + degraded mode + crash/fork recovery"
python scripts/torch_chaos_smoke.py ${DEV_ARGS[@]+"${DEV_ARGS[@]}"}
done_step

step "attack-resilience example (smoke)"
python examples/torch_attack_resilience.py --clients 6 --rounds 3 \
    --per-client 48 --reselect-every 3 ${DEV_ARGS[@]+"${DEV_ARGS[@]}"}
done_step

if [[ "$DEVICE" == cpu ]]; then
    step "16-client federation dry run on the tiled backend (CPU size)"
    python -m repro_torch.launch.fed --dryrun --clients 16 \
        --ref-mode public --tiling tiled --device cpu
else
    step "1024-client federation dry run on the tiled backend"
    python -m repro_torch.launch.fed --dryrun --clients 1024 \
        --ref-mode public --tiling tiled
fi
done_step

echo "CI OK"
