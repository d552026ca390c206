"""Multi-turn chat workflow: respond -> index the reply (session memory).

The stateful-serving scenario (DESIGN.md §9): every arrival is one *turn*
of an ongoing session. The ``chat_respond`` interface declares its token
model in history units — ``in_units="history_tokens"`` grows the prompt
with conversation length, ``prefix_units="history_tokens"`` marks that
history span as session-shared — so a turn served on an instance whose KV
cache holds the session's prefix pays prefill only for the new message.
Nothing in core knows chat exists; the engine sees ``prefix_tokens`` on
the lowered node and a ``session`` id on the job.

Deliberately *not* imported by ``SCENARIOS._ensure_builtin``: registering
the chat preset into ``default_mix()`` would shift the serving bench's
pinned baselines. Import this module explicitly (the cache bench and the
residency tests do) to register the scenario and its serving preset.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.spec import SCENARIOS, Scenario

# per-turn token geometry: the footprint arithmetic below makes each
# turn's history exactly the previous turn's full prompt+reply, so a
# session resident in an instance's KV cache serves the *entire* history
# prefix (see tests/test_cache_residency.py). MESSAGE/REPLY must match the
# chat_respond interface's TokenModel (tokens_in/tokens_out) for that
# identity to hold. The geometry is a tool-calling agent's: a fat system
# prompt (tool schemas + few-shot examples), fat per-turn context, short
# structured replies — prefill-compute-bound, where prefix reuse pays.
SYSTEM_TOKENS = 6000      # session-constant system prompt + tool schemas
MESSAGE_TOKENS = 640      # one user message + retrieved/tool context
REPLY_TOKENS = 24         # one short structured (tool-call) reply


@dataclass(frozen=True)
class ChatTurnInput:
    """One user turn of an ongoing chat session."""

    session: str
    turn: int = 0
    message_tokens: int = MESSAGE_TOKENS
    reply_tokens: int = REPLY_TOKENS
    system_tokens: int = SYSTEM_TOKENS

    artifact = "chat_turn"

    def units(self) -> dict[str, int]:
        """Unit breakdown driving interface cardinality/token models."""
        history = self.system_tokens + \
            self.turn * (self.message_tokens + self.reply_tokens)
        return {"turns": 1, "history_tokens": history}


CHAT_SCENARIO = SCENARIOS.register(Scenario(
    name="chat_agent",
    input_artifacts=("chat_turn",),
    default_tasks=(
        "Respond to the user's chat message with the assistant reply",
    ),
    aggregate_tasks=(
        "Insert the reply embedding into the session memory vector index",
    ),
    arg_builders={
        "chat_respond": lambda job: {"message": "$chat_turn",
                                     "max_tokens": REPLY_TOKENS},
        "embed": lambda job: {"texts": "$chat_reply"},
    }))


def make_chat_job(constraints=None, session: str = "", turn: int = 0):
    """Declarative chat-turn job (session-aware: one job per turn)."""
    from ..core.workflow import MIN_COST, Job
    return Job(
        description=f"Serve chat turn {turn} of an ongoing session",
        inputs=(ChatTurnInput(session=session or "adhoc", turn=turn),),
        constraints=MIN_COST if constraints is None else constraints,
        quality_floor={"chat_respond": 0.85, "embed": 0.85},
        session=session)


# -- open-loop serving preset (core/arrivals.py) ------------------------------
# interactive chat: tight SLO, session-aware lowering (one template per
# turn index — history grows the token footprint)
from ..core.arrivals import ServingPreset, register_preset  # noqa: E402

SERVING_PRESET = register_preset(ServingPreset(
    scenario="chat", make_job=make_chat_job, weight=0.35, base_slo_s=30.0,
    session_aware=True))
