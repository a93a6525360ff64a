"""Entry points of the port (the training driver)."""
