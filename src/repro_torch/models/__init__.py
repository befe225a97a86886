"""Models of the torch port: config, layers and the model API (the dense
family; the other families are still to port)."""
