"""Model configs, layers, the dense stack and the serving facade."""
