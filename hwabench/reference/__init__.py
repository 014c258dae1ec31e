"""Plain references of the configurations: ``<name>.py``, named by a
configuration file's ``reference`` key."""
