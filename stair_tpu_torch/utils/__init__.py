"""Device helpers: card identity and CUDA-event timing."""
