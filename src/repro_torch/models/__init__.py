"""Model substrate shared by the architectures: parameter declaration and
initialisation, and the dense, moe and vlm LM families (``attention``,
``mlp``, ``moe``, ``lm``)."""
