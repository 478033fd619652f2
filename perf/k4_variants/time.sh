#!/bin/sh
# K4's design variants, timed against the committed design on an H100.
#
# Each NAME.patch here is one edit of stereo_reconstruction_tpu_torch/csrc/
# perceptual_scan.{cuh,cu} that was tried and dropped: gather (no layout
# pass; the scan copies D words strided by W a row, 4 bytes each),
# neighbours (per-neighbour mbarriers in place of the diagonal's),
# syncthreads (a __syncthreads a diagonal), precompute (the row weight
# applied in the ring ahead of the step), per_warp2 (two positions a
# warp), shuffle (a 5-round shuffle in place of the two redux), unroll4
# and divergent (the candidate loop unrolled by 4 with the same or a
# per-lane trip count, in place of branch-free groups of 4), masked_branch
# (the mask of candidates past D as a `?:`, which compiles to a branch).
# no_copy (no copies into the ring), no_wait (no wait for the diagonal's
# phase), no_redux (lane 0's own minimum, no warp reduction) and clocks
# (clock64 around each part; perf/k4_variants/clocks.py in its copy prints
# the cycles) are wrong by design: they measure what each part costs. The
# others are bit-equal to the plain twin:
# tests/test_torch_perceptual_scan_host.py passes on a patched copy of the
# tree, gather excepted (the host stand-ins copy 16 bytes only). From the
# root of the repo:
#
#   perf/k4_variants/time.sh prepare    # a patched copy of the port for each
#                                       # variant, under build/k4_variants/
#   perf/k4_variants/time.sh time       # on a machine with the card
#
# `time` runs `python3 chip_smoke.py --time-kernels K4` in this checkout and
# in each copy, in order and then in reverse, and prints each run's JSON
# line: "checkout" names the variant, "ms" holds K4 at 375x450, chunk 20
# (D=100, D=200, and one 20-column strip alone).
set -e
cd "$(dirname "$0")/../.."
out=build/k4_variants
names=$(ls perf/k4_variants | sed -n 's/\.patch$//p')
case "$1" in
prepare)
  rm -rf "$out"
  for n in $names; do
    mkdir -p "$out/$n"
    cp -r chip_smoke.py stereo_reconstruction_tpu_torch tests "$out/$n/"
    rm -rf "$out/$n/build"
    patch -s -d "$out/$n" -p1 < "perf/k4_variants/$n.patch"
  done ;;
time)
  dirs=". $(for n in $names; do printf '%s ' "$out/$n"; done)"
  for d in $dirs $(printf '%s\n' $dirs | awk '{a[NR] = $0} END {for (i = NR; i; i--) print a[i]}'); do
    (cd "$d" && python3 chip_smoke.py --time-kernels K4)
  done ;;
*)
  echo "usage: $0 prepare | time" >&2
  exit 2 ;;
esac
