"""Model substrate shared by the architectures (parameter declaration and
initialisation; the LM families follow with the LM slice of the port)."""
