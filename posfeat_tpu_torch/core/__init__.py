"""Device resolution, config files and weight conversion."""
