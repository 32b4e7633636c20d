"""Architecture configs of the port."""
