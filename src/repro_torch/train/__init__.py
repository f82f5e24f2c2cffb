"""Training-side pieces of the port (counterpart of src/repro/train/)."""
