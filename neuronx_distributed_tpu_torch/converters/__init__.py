"""Weight converters into the port's state dicts."""
