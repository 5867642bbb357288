"""Ray, sampling, encoding and compositing ops on torch tensors."""
