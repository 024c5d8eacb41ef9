"""The NMN model: module helpers and ``VideoNMN``."""
