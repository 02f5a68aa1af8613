"""The hybrid-parallel optimizer and grad scaler."""
