"""L3 communication: asyncio messenger with v2-style framing.

Analog of src/msg/ (Messenger/Connection/Dispatcher/Policy) — see
messenger.py for the transport and messages.py for the wire types.
"""

from .faults import FaultInjector, FaultRule
from .message import Message, decode_message, encode_message, register
from .messenger import Connection, Messenger, Policy

# importing .messages populates the wire registry as a side effect so
# any Messenger user can decode inbound frames
from . import messages  # noqa: F401  (registry side effect)

__all__ = [
    "Message", "register", "encode_message", "decode_message",
    "Messenger", "Connection", "Policy",
    "FaultInjector", "FaultRule",
]
