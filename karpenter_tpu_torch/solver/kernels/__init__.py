"""Hand-written CUDA kernels for the two device entries of the solve.

- ffd_scan: the fused FFD scan (replaces the Pallas `_fused_scan`);
- disrupt_repack: the candidate-set repack (replaces the Pallas
  `disrupt_repack_pallas`).

Each module holds its kernel's wrapper, a plain torch version of the same
function, and a launch count. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises -- no
fallback hides a missing card or a failed kernel. The kernels build with
nvcc at first use (build.py), never at import.
"""
