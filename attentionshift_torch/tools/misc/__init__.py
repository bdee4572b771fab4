"""Small user tools: the resolved config (``print_config``)."""
