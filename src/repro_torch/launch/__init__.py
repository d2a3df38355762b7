"""Entry points of the port's language-model serving and training paths."""
