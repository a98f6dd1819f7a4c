"""REINFORCE policy gradient on a 5 x 5 gridworld with the PyTorch port
(counterpart of ``examples/reinforce_gridworld.py``; reference
example/reinforcement-learning)::

    python -m mxnet_tpu_torch.examples.reinforce_gridworld [--ctx cpu]

The policy net trains through ``MakeLoss(-log pi(a|s) * advantage)``
(pick, log_softmax and the BlockGrad'ed advantages): the score-function
estimator as a Symbol graph. The mean episode return must rise by 0.5 over
the random policy's.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

import mxnet_tpu_torch as mx

from .common import add_fit_args, default_context, get_context

GRID = 5
N_STATES = GRID * GRID
N_ACT = 4  # up / down / left / right
GOAL = (GRID - 1, GRID - 1)
HORIZON = 12
STEP_R = -0.05
GOAL_R = 1.0


def step(state, act):
    r, c = divmod(state, GRID)
    dr, dc = [(-1, 0), (1, 0), (0, -1), (0, 1)][act]
    r2, c2 = min(max(r + dr, 0), GRID - 1), min(max(c + dc, 0), GRID - 1)
    done = (r2, c2) == GOAL
    return r2 * GRID + c2, (GOAL_R if done else STEP_R), done


def rollout(probs_fn, rng, n_episodes):
    """Episodes of the current policy: flat (states, actions, returns) and
    the mean episode return."""
    S, A, R = [], [], []
    ep_returns = []
    for _ in range(n_episodes):
        s = rng.randint(0, N_STATES - 1)
        traj, rewards = [], []
        for _t in range(HORIZON):
            a = rng.choice(N_ACT, p=probs_fn(s))
            s2, r, done = step(s, a)
            traj.append((s, a))
            rewards.append(r)
            s = s2
            if done:
                break
        ret = 0.0
        returns = []
        for r in reversed(rewards):
            ret = r + 0.98 * ret
            returns.append(ret)
        returns.reverse()
        for (st, ac), g in zip(traj, returns):
            S.append(st)
            A.append(ac)
            R.append(g)
        ep_returns.append(sum(rewards))
    return (np.asarray(S, np.float32), np.asarray(A, np.float32), np.asarray(R, np.float32),
            float(np.mean(ep_returns)))


def build_policy():
    state = mx.sym.Variable("state")
    act = mx.sym.Variable("action")
    adv = mx.sym.Variable("advantage")
    onehot = mx.sym.one_hot(state, depth=N_STATES)
    h = mx.sym.FullyConnected(onehot, num_hidden=64, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    logits = mx.sym.FullyConnected(h, num_hidden=N_ACT, name="fc2")
    logp = mx.sym.log_softmax(logits, axis=-1)
    chosen = mx.sym.pick(logp, act, axis=-1)
    loss = mx.sym.MakeLoss(-chosen * mx.sym.BlockGrad(adv), name="pg_loss")
    probs = mx.sym.BlockGrad(mx.sym.softmax(logits, axis=-1), name="probs")
    return mx.sym.Group([loss, probs])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_fit_args(p)
    p.add_argument("--iters", type=int, default=60)
    p.add_argument("--episodes", type=int, default=64)
    p.set_defaults(lr=0.05)
    return p.parse_args(argv)


def run(args):
    """Train; returns {"base", "final"} mean returns (asserts final > base +
    0.5)."""
    ctx = get_context(args)
    one_ctx = ctx[0] if isinstance(ctx, list) else ctx
    rng = np.random.RandomState(0)
    np.random.seed(0)
    mx.random.seed(0)
    sym = build_policy()
    # bound once at the largest flat batch; shorter batches are padded
    max_n = args.episodes * HORIZON
    exe = sym.simple_bind(ctx=one_ctx, state=(max_n,), action=(max_n,), advantage=(max_n,),
                          grad_req="write")
    init = mx.init.Xavier()
    for name, arr in exe.arg_dict.items():
        if name not in ("state", "action", "advantage"):
            init(mx.init.InitDesc(name), arr)
    # the mean over the REAL steps: padding gives zero gradient
    opt = mx.optimizer.create("adam", learning_rate=args.lr, rescale_grad=1.0)
    updater = mx.optimizer.get_updater(opt)
    params = [n for n in exe.arg_dict if n not in ("state", "action", "advantage")]

    def policy_table():
        states = np.arange(N_STATES, dtype=np.float32)
        exe.arg_dict["state"][:] = np.resize(states, max_n)
        out = exe.forward(is_train=False)[1].asnumpy()[:N_STATES]
        return out / out.sum(axis=1, keepdims=True)

    base_return = None
    for it in range(args.iters):
        table = policy_table()
        S, A, R, mean_ret = rollout(lambda s: table[s], rng, args.episodes)
        if base_return is None:
            base_return = mean_ret  # the near-random policy's
        adv = (R - R.mean()) / len(S)
        pad = max_n - len(S)
        exe.arg_dict["state"][:] = np.pad(S, (0, pad))
        exe.arg_dict["action"][:] = np.pad(A, (0, pad))
        exe.arg_dict["advantage"][:] = np.pad(adv, (0, pad))
        exe.forward(is_train=True)
        exe.backward()
        for i, name in enumerate(params):
            updater(i, exe.grad_dict[name], exe.arg_dict[name])
        if (it + 1) % 15 == 0:
            print("iter %3d mean return %.3f" % (it + 1, mean_ret))
    final = mean_ret
    print("random-policy return %.3f -> trained %.3f" % (base_return, final))
    assert final > base_return + 0.5, (base_return, final)
    return {"base": base_return, "final": final}


def main(argv=None):
    args = parse_args(argv)
    with default_context(args):
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
