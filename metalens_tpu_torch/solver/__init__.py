"""The RCWA solver of the port (counterpart of ``metalens_tpu/solver``).

Modules:
  orders   -- reciprocal-lattice truncation (copied, numpy)
  special  -- J1 Bessel fit (analytic ellipse Fourier transform)
  cpx      -- dtype policy, complex helpers, the routing of dense solves
  inv      -- batched complex inverse: CUDA kernel + plain version
  epsilon  -- Toeplitz eps matrices of ellipse layouts
  fff      -- normal-vector Fourier factorization (NV) blocks
  basis    -- S4-convention plane-wave bases, incident vectors, powers
  taylor   -- thin-slab Taylor factors: CUDA kernel + plain version
  rcwa     -- eig-free S-matrix solver (thin-slab expm + Redheffer doubling)
  fom      -- figure of merit as data + scoring
"""
