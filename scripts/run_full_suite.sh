#!/usr/bin/env bash
# Full test tier, one pytest process per module.
#
# The whole-suite single-process run compiles many hundreds of distinct
# XLA:CPU programs and the compiler has been seen to segfault inside
# backend_compile_and_load (the crash site moved with the accumulated
# compile count; every module passed in isolation; jax.clear_caches()
# between modules did not prevent it).
# Per-module processes bound the compiler state and make the full tier
# deterministic.  The smoke tier (-m "not slow") stays single-process.
set -u
cd "$(dirname "$0")/.."
fail=0
declare -a failed

run_chunk() {
    echo "=== $1 ==="
    if ! python -m pytest "$1" -q "${EXTRA_ARGS[@]}"; then
        fail=1
        failed+=("$1")
    fi
}

EXTRA_ARGS=("$@")
for f in tests/test_*.py; do
    if [ "$(grep -c '^class Test' "$f")" -ge 8 ]; then
        # Compile-heavy modules cross the compiler-state threshold even
        # alone — split those per class.
        for cls in $(grep -o '^class Test[A-Za-z0-9_]*' "$f" \
                     | sed 's/^class //'); do
            run_chunk "$f::$cls"
        done
    else
        run_chunk "$f"
    fi
done
if [ "$fail" -ne 0 ]; then
    echo "FAILED modules: ${failed[*]}"
else
    echo "ALL MODULES PASSED"
fi
exit "$fail"
