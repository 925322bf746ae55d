"""The serve block's data plane: step factories and continuous batching."""
