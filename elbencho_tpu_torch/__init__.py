"""elbencho-tpu-torch: the PyTorch/CUDA port of elbencho-tpu's device data path.

A second package beside ``elbencho_tpu`` that runs the same storage
benchmark through the memory of an NVIDIA GPU instead of a TPU's HBM:
storage -> page-aligned host I/O slot -> device memory, pipelined to
``--iodepth``, with the read-side integrity check done on the device by a
hand-written CUDA kernel (``csrc/fingerprint.cu``).

It imports ``torch`` and ``numpy`` and nothing of JAX or of
``elbencho_tpu``: every module it needs from the JAX package is a
cut-down copy under the same module path, so a reader finds each
counterpart by name.

Package layout:
  toolkits/   units, logger, offset generators, the "fast" PRNG
  config/     the flag subset of the port (dir mode, file mode on files
              or block devices, --gpu* flags)
  workers/    LocalWorker dir-mode and block loops, WorkerManager, shared
              phase state
  stats/      phase results, JSON records, latency histograms, CPU util
  utils/      the page-aligned staging pool (cudaHostRegister under
              --gpudirect)
  cuda/       CudaWorkerContext: H2D/D2H transfer ring on a CUDA stream
  ops/        device ops: verify pattern / random fill (torch), the
              fingerprint kernel wrapper and its build
  csrc/       CUDA C++ sources, built with nvcc at first use
"""

__version__ = "0.1.0"
