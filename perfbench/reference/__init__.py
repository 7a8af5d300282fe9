"""Plain float32 references, one module per model family, named as the
family is in a configuration file (``perfbench/configs/*.json``).  They
import nothing of the program under test."""
