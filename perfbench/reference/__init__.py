"""The plain reference: numpy only, never the program (``repro_torch``) nor the
JAX package.  It recomputes what the program returns from the inputs the
benchmark made."""
