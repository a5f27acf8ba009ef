"""SDF, radiance, density, sampler and renderer."""
