"""Scripts that count what the port's programs compute."""
