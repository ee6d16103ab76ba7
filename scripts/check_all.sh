#!/usr/bin/env bash
# Full pre-snapshot gate: the suite, the multi-device dry run and the
# entry compile smoke, all on the CPU.
#
#   bash scripts/check_all.sh            # full suite + dryrun + CPU smoke
#   bash scripts/check_all.sh --gpu      # additionally run chip_smoke.py
#                                        # and bench.py (needs a GPU)
#
# Exit 0 = everything green; prints a one-line JSON summary.
set -u
cd "$(dirname "$0")/.."
REPO="$PWD"
FAIL=0

echo "== [1/3] full pytest suite (virtual 8-device CPU mesh) =="
start=$(date +%s)
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow' 2>&1 | tail -4
rc=${PIPESTATUS[0]}
t_suite=$(( $(date +%s) - start ))
if [ "$rc" -ne 0 ]; then echo "SUITE FAILED (rc=$rc)"; FAIL=1; fi
echo "suite: rc=$rc ${t_suite}s"

echo "== [2/3] dryrun_multichip(8) on virtual CPU devices =="
start=$(date +%s)
JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" \
  AVR_COMPILE_CACHE=off \
  python -c "
import __graft_entry__ as g
g.dryrun_multichip(8)
print('dryrun OK')
" 2>&1 | tail -3
rc=${PIPESTATUS[0]}
t_dry=$(( $(date +%s) - start ))
if [ "$rc" -ne 0 ]; then echo "DRYRUN FAILED (rc=$rc)"; FAIL=1; fi
echo "dryrun: rc=$rc ${t_dry}s"

echo "== [3/3] entry() compile smoke (CPU) =="
start=$(date +%s)
JAX_PLATFORMS=cpu AVR_COMPILE_CACHE=off python -c "
import jax
jax.config.update('jax_platforms', 'cpu')
import __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn).lower(*args).compile()
print('entry compile OK')
" 2>&1 | tail -3
rc=${PIPESTATUS[0]}
t_entry=$(( $(date +%s) - start ))
if [ "$rc" -ne 0 ]; then echo "ENTRY SMOKE FAILED (rc=$rc)"; FAIL=1; fi
echo "entry: rc=$rc ${t_entry}s"

if [ "${1:-}" = "--gpu" ]; then
  echo "== [extra] chip_smoke.py + bench.py on the GPU =="
  python chip_smoke.py 2>&1 | tail -2
  rc=${PIPESTATUS[0]}
  if [ "$rc" -ne 0 ]; then echo "CHIP SMOKE FAILED (rc=$rc)"; FAIL=1; fi
  PYTHONPATH="$REPO" python bench.py 2>&1 | tail -2
  rc=${PIPESTATUS[0]}
  if [ "$rc" -ne 0 ]; then echo "BENCH FAILED (rc=$rc)"; FAIL=1; fi
fi

if [ "$FAIL" -eq 0 ]; then
  echo "{\"check_all\": \"green\", \"suite_s\": $t_suite, \"dryrun_s\": $t_dry, \"entry_s\": $t_entry}"
else
  echo "{\"check_all\": \"RED\"}"
fi
exit $FAIL
