"""Entry points that drive the models: the serving engine."""
