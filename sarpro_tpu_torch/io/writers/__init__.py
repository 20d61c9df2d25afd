"""Output writers of the port."""
