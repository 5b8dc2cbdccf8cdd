"""Config flags, weight conversion and logging."""
