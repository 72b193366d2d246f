"""Chat-template rendering (HF ``chat_template`` conventions): the port's
own copy of ``deepseek_tpu/chat.py``.

The reference has no chat surface at all — its interactive mode feeds raw
completion prompts (main.cpp:514-592) and users hand-format turns. Real
DeepSeek checkpoints ship a Jinja chat template in ``tokenizer_config.json``;
the converter embeds it in the ``.dseek`` metadata (key ``chat_template``)
and this module renders it the way HF ``apply_chat_template`` does: a
sandboxed immutable Jinja environment with ``messages`` / ``bos_token`` /
``eos_token`` / ``add_generation_prompt`` in scope and the
``raise_exception`` helper HF templates call on malformed conversations.

Consumer: ``-m chat`` (the CLI REPL). jinja2 is imported inside
``render_chat`` only, so the package loads where jinja2 is missing.
"""

from __future__ import annotations

from typing import Dict, List


class ChatTemplateError(ValueError):
    pass


def render_chat(
    template: str,
    messages: List[Dict[str, str]],
    bos_token: str = "",
    eos_token: str = "",
    add_generation_prompt: bool = True,
) -> str:
    """Render ``messages`` ([{"role": ..., "content": ...}, ...]) through a
    HF-convention Jinja chat template -> the prompt string to tokenize.

    Matches transformers' environment semantics: ImmutableSandboxed
    environment, ``trim_blocks``/``lstrip_blocks``, ``tojson`` available
    (jinja2 builtin), and ``raise_exception`` raising a template error.
    """
    try:
        import jinja2
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as e:
        raise ChatTemplateError(f"chat templates need jinja2: {e}")

    for i, m in enumerate(messages):
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise ChatTemplateError(
                f"message {i} must be a dict with 'role' and 'content'")

    def raise_exception(msg):
        raise ChatTemplateError(f"chat template error: {msg}")

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        undefined=jinja2.Undefined)
    env.globals["raise_exception"] = raise_exception
    try:
        return env.from_string(template).render(
            messages=messages,
            bos_token=bos_token,
            eos_token=eos_token,
            add_generation_prompt=add_generation_prompt,
        )
    except ChatTemplateError:
        raise
    except jinja2.TemplateError as e:
        raise ChatTemplateError(f"chat template failed to render: {e}")
