"""Models: ResNet and the converter from the JAX parameters."""
