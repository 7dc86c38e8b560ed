#!/bin/sh
# Build the native IO library into build/native/ (gitignored), keyed on a
# hash of the source and flags -- the same build patchwork_tpu/io/native.py
# runs on first use.
set -e
cd "$(dirname "$0")/.."
python -c "from patchwork_tpu.io.native import build_library; print('built', build_library())"
