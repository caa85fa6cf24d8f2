"""Static analyses of the digit walks (numpy only)."""
