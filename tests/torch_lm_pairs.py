"""Shared helpers of the language-model parity tests: one smoke config
in both packages with the reference's weights carried across, the
reference's ``serve_batch`` loop without its mesh (jitted prefill and
decode, greedy), and the port's side of the same checks.

Tolerance: float32, ``atol = rtol = 1e-4`` (summation orders differ
between the packages)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.launch import serve
from repro_torch.models import transformer as T

TOL = dict(atol=1e-4, rtol=1e-4)


def close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def port_cfg(jcfg) -> ModelConfig:
    """The port's config with the reference config's fields."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    if jcfg.moe is not None:
        fields["moe"] = MoEConfig(**dataclasses.asdict(jcfg.moe))
    return ModelConfig(**fields)


def ported(tree) -> dict:
    """A reference parameter (sub)tree as CPU tensors."""
    if isinstance(tree, dict):
        return {k: ported(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def leaves(tree):
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else (v,))


def smoke_jcfg(arch: str, **changes):
    """The reference's smoke config of ``arch``; ``capacity_factor`` is
    set on its MoE config, any other change on the config itself."""
    jcfg = jconfigs.get(arch, smoke=True)
    cf = changes.pop("capacity_factor", None)
    if cf is not None:
        changes["moe"] = dataclasses.replace(jcfg.moe, capacity_factor=cf)
    return dataclasses.replace(jcfg, **changes)


@dataclasses.dataclass
class Model:
    """One smoke model in both packages, the port's weights the
    reference's."""

    arch: str
    jcfg: object
    jparams: dict
    cfg: ModelConfig
    params: dict

    @classmethod
    def build(cls, arch: str, seed: int = 0, **changes) -> "Model":
        jcfg = smoke_jcfg(arch, **changes)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(seed),
                                    jnp.float32)
        cfg = port_cfg(jcfg)
        params = T.params_from_reference(jax.tree.map(np.asarray, jparams),
                                         cfg, "cpu")
        return cls(arch, jcfg, jparams, cfg, params)

    # -- the reference ----------------------------------------------------

    def jax_forward(self, toks, *, embeds=None, enc=None):
        logits, aux, _ = JT.forward(
            self.jparams, self.jcfg,
            None if toks is None else jnp.asarray(toks, jnp.int32),
            embeds=None if embeds is None else jnp.asarray(embeds),
            enc_embeds=None if enc is None else jnp.asarray(enc))
        return np.asarray(logits), float(aux)

    def jax_greedy(self, prompts, max_new, t_max):
        """The reference's ``serve_batch`` loop, without its mesh:
        left-padded prompts, a jitted prefill (zero encoder embeddings
        for an enc-dec) and jitted greedy decode steps.  Returns the
        padded prompts, the emitted tokens ``(B, max_new)`` and the last
        position's logits after the prefill and after each step."""
        jcfg, b = self.jcfg, len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((b, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
        enc = (jnp.zeros((b, plen, jcfg.d_model), jnp.float32)
               if jcfg.family == "encdec" else None)

        @jax.jit
        def prefill(params, tokens, cache):
            logits, _, cache = JT.forward(params, jcfg, tokens,
                                          enc_embeds=enc, cache=cache)
            return logits[:, -1], cache

        @jax.jit
        def decode(params, tok, cache):
            logits, cache = JT.decode_step(params, jcfg, tok, cache)
            return logits[:, -1], cache

        cache = JT.init_cache(jcfg, b, t_max, jnp.float32)
        last, cache = prefill(self.jparams, jnp.asarray(toks), cache)
        steps, out = [np.asarray(last)], []
        for _ in range(max_new):
            tok = jnp.argmax(last, -1).astype(jnp.int32)
            out.append(np.asarray(tok))
            last, cache = decode(self.jparams, tok[:, None], cache)
            steps.append(np.asarray(last))
        return toks, np.stack(out, 1), steps

    # -- the port ----------------------------------------------------------

    def serve(self, prompts, max_new, t_max):
        reqs = [serve.Request(p, max_new=max_new) for p in prompts]
        stats = serve.serve_batch(self.cfg, reqs, t_max=t_max,
                                  device="cpu", params=self.params)
        return np.array([r.out for r in reqs]), stats

    def teacher_forced(self, toks, emitted, t_max):
        """The port's last-position logits after a prefill of ``toks``
        and after each decode step fed ``emitted``'s columns."""
        cfg, b = self.cfg, toks.shape[0]
        enc = (torch.zeros((b, toks.shape[1], cfg.d_model))
               if cfg.family == "encdec" else None)
        cache = T.init_cache(cfg, b, t_max, torch.float32, "cpu")
        logits, cache = T.forward(self.params, cfg, t(toks).long(),
                                  enc_embeds=enc, cache=cache)
        steps = [logits[:, -1]]
        for i in range(emitted.shape[1]):
            logits, cache = T.decode_step(
                self.params, cfg, t(emitted[:, i:i + 1]).long(), cache)
            steps.append(logits[:, -1])
        return steps


def prompts(vocab, lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n) for n in lengths]


def check_serving(m: Model, lengths, max_new=8, t_max=None, seed=7):
    """The port's ``serve_batch`` against the reference's loop: the
    same greedy tokens, and the same logits at every step when the port
    is teacher-forced on the reference's tokens."""
    ps = prompts(m.cfg.vocab, lengths, seed)
    t_max = t_max or max(lengths) + max_new
    toks, jout, jsteps = m.jax_greedy(ps, max_new, t_max)
    out, stats = m.serve(ps, max_new, t_max)
    assert stats["decode_steps"] == max_new and stats["tok_per_s"] > 0
    np.testing.assert_array_equal(out, jout)
    close(stats["last_logits"], jsteps[-1])
    for got, want in zip(m.teacher_forced(toks, jout, t_max), jsteps):
        close(got, want)


def check_decode_matches_forward(m: Model, n=12, split=9, *, seed=9,
                                 enc=None):
    """Prefill ``split`` tokens, decode the rest one at a time: each
    step's logits equal the full forward's at that position."""
    cfg = m.cfg
    toks = t(np.random.default_rng(seed).integers(0, cfg.vocab, (2, n)))
    full, _ = T.forward(m.params, cfg, toks, enc_embeds=enc)
    cache = T.init_cache(cfg, 2, n + 2, torch.float32, "cpu")
    _, cache = T.forward(m.params, cfg, toks[:, :split], enc_embeds=enc,
                         cache=cache)
    for i in range(split, n):
        step, cache = T.decode_step(m.params, cfg, toks[:, i:i + 1], cache)
        close(step[:, 0], full[:, i].numpy())
    assert cache["pos"] == n
