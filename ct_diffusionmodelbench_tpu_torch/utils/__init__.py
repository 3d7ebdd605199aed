"""JSON sanitization and timestamped logging."""
