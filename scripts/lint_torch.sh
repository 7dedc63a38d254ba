#!/usr/bin/env bash
# Static-contract gate of the PyTorch port: repro_torch.lint over
# src/repro_torch (see src/repro_torch/README.md "The lint").  Exit 0 iff
# clean.  Usage: scripts/lint_torch.sh [extra repro_torch.lint args...]
# The incremental cache (.lint-cache-torch.json, gitignored) replays the
# findings of an unchanged tree.  On a machine with the card, the device
# half: scripts/lint_torch.sh --device cuda --select kernel-memory,kernel-race
set -euo pipefail
cd "$(dirname "$0")/.."
PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}" \
    exec python -m repro_torch.lint src/repro_torch --format text --cache "$@"
