from ragmeup_tpu_torch.server.app import RagServer, create_wsgi_app

__all__ = ["RagServer", "create_wsgi_app"]
