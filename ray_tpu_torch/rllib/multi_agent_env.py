"""MultiAgentEnv: the dict-keyed environment interface, the port of
ray_tpu/rllib/multi_agent_env.py.

Observations, rewards and done flags are dicts keyed by agent id;
``terminateds`` / ``truncateds`` carry the special ``"__all__"`` key that
ends the episode for everyone. Agents map to policies through
``policy_mapping_fn`` (multi_agent.py): several agents may share one policy
or each own one. As in the reference, envs are **simultaneous-move**: every
agent in ``possible_agents`` observes and acts on every step, so each
policy's rollouts are rectangular ([T, n_agents] arrays).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class MultiAgentEnv:
    #: stable agent ids, all present every step (simultaneous-move)
    possible_agents: Tuple[str, ...] = ()

    def observation_space(self, agent_id: str):
        raise NotImplementedError

    def action_space(self, agent_id: str):
        raise NotImplementedError

    def reset(self, seed: Optional[int] = None) -> Tuple[Dict[str, Any], Dict]:
        """-> (obs_dict, infos_dict)"""
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]) -> Tuple[Dict, Dict, Dict, Dict, Dict]:
        """-> (obs, rewards, terminateds, truncateds, infos), all dicts
        keyed by agent id; terminateds/truncateds also carry "__all__"."""
        raise NotImplementedError

    def close(self):
        pass


def episode_done(terminateds: Dict, truncateds: Dict) -> bool:
    """The episode ends when "__all__" is flagged or every agent is
    individually done."""
    if terminateds.get("__all__") or truncateds.get("__all__"):
        return True
    agent_keys = {k for k in (*terminateds, *truncateds) if k != "__all__"}
    return bool(agent_keys) and all(
        terminateds.get(k) or truncateds.get(k) for k in agent_keys
    )
