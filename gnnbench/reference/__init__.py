"""Plain references, one module per model family (``reference/<family>.py``):
``param_specs(cfg)`` names the weights the benchmark makes and
``forward(params, g, x, rnd)`` computes the logits in float32, rounding
with ``rnd`` where the lower-precision control rounds."""
