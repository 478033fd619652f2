#!/bin/sh
# K1b's design variants, timed against the committed design on an H100.
#
# Each NAME.patch here is one edit of stereo_reconstruction_tpu_torch/csrc/
# row_scan.cuh that was tried and dropped; no_handoff removes the hand-off
# (its output is wrong) to measure what the hand-offs cost. The others are
# bit-equal to the plain twin: tests/test_torch_row_scan_host.py passes on
# a patched copy of the tree (release also needs a host stand-in for
# peer_send_release in tests/k1b_host/primitives.inc). From the root of the
# repo:
#
#   perf/k1b_variants/time.sh prepare   # a patched copy of the port for each
#                                       # variant, under build/k1b_variants/
#   perf/k1b_variants/time.sh time      # on a machine with the card
#
# `time` runs `python3 chip_smoke.py --time-kernels` in this checkout and in
# each copy, in order and then in reverse, and prints each run's JSON line:
# "checkout" names the variant, "ms" holds K1b at (b) 1128x1408, D=200 and
# K1b_tile on the 282-row seeded tile.
set -e
cd "$(dirname "$0")/../.."
out=build/k1b_variants
names=$(ls perf/k1b_variants | sed -n 's/\.patch$//p')
case "$1" in
prepare)
  rm -rf "$out"
  for n in $names; do
    mkdir -p "$out/$n"
    cp -r chip_smoke.py stereo_reconstruction_tpu_torch tests "$out/$n/"
    rm -rf "$out/$n/build"
    patch -s -d "$out/$n" -p1 < "perf/k1b_variants/$n.patch"
  done ;;
time)
  dirs=". $(for n in $names; do printf '%s ' "$out/$n"; done)"
  for d in $dirs $(printf '%s\n' $dirs | awk '{a[NR] = $0} END {for (i = NR; i; i--) print a[i]}'); do
    (cd "$d" && python3 chip_smoke.py --time-kernels)
  done ;;
*)
  echo "usage: $0 prepare | time" >&2
  exit 2 ;;
esac
