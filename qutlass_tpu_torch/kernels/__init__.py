"""Hand-written Hopper kernels: build, load and wrappers."""
