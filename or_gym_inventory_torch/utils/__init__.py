"""JAX interop for the tests and CUDA-event timing."""
