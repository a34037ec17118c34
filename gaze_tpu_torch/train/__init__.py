"""Training stages of the port: SP, AT and LF (see ``stages``)."""
