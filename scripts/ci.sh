#!/usr/bin/env bash
# CI entry point: install + fast test tier on a virtual 8-device CPU mesh.
#
# tests/conftest.py self-configures the 8-device CPU mesh in-process; the
# platform is forced via env as well so that hosts with a GPU plugin
# behave identically.  GPU checks are chip_smoke.py (see README).
set -euo pipefail
cd "$(dirname "$0")/.."

python -m pip install -e '.[test]' --quiet

export JAX_PLATFORMS=cpu
python -m pytest tests/ -x -q -m "not slow" "$@"
