"""mfu.batch: ``mfu`` in a batched cell: the matcher's operations on one
pair at the configuration's image size over the window's mean time a pair
and 67 TFLOP/s, in %. A lower bound: the batch is matched on the canvas
of its padded shape (1128x1536 for 750x900 pairs, against 1128x1408), and
no pose operation is counted."""

from benchmark.metrics.mfu import read  # noqa: F401
