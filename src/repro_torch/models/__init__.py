"""Model substrate shared by the architectures: parameter declaration and
initialisation, and the dense LM family (``attention``, ``mlp``, ``lm``)."""
