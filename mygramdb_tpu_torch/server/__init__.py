from .._overlay import extend_path

__path__ = extend_path(__path__, __name__)
