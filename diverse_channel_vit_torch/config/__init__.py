from .loader import CONFIG_DIR, Config, load_config, parse_overrides

__all__ = ["CONFIG_DIR", "Config", "load_config", "parse_overrides"]
