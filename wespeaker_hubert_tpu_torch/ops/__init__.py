"""Feature frontend: fbank (plain and CUDA kernel), CMVN, pipeline."""
