"""The environment of a benchmark process, set before NumPy or torch is
imported: fixed cache directories inside the checkout (the program's
kernel library lands in ``build/stpu_torch_kernels/`` by itself), and one
host thread for each thread pool, so that a run's load is one process
with few threads."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_environment(root: str = ROOT) -> dict:
    base = os.path.join(root, "build", "bench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda"),
            "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
