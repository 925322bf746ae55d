"""The train block: quantized optimizer state, AdamW, the train step."""
