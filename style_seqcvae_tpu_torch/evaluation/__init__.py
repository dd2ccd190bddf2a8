"""Caption metrics of the port."""
