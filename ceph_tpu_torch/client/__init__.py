"""L6 client access: librados-equivalent with client-side placement.

Analog of src/librados + src/osdc — see rados.py (RadosClient/IoCtx/
Objecter logic).
"""

from .rados import IoCtx, ObjectNotFound, RadosClient, RadosError

__all__ = ["RadosClient", "IoCtx", "RadosError", "ObjectNotFound"]
