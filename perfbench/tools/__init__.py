"""Tools that read a traced run of a cell; no cell runs them."""
