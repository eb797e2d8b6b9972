"""MiniGrid as batched tensors: every MiniGrid and BabyAI id of the JAX package.

Port of ``clip_ppo_tpu/envs/minigrid/core.py``: Empty[-Random], DoorKey,
FourRooms, LavaGap, DistShift, MultiRoom, {Simple,Lava}Crossing,
Dynamic-Obstacles[-Random], Unlock, UnlockPickup, BlockedUnlockPickup,
ObstructedMaze (1Dl{,h,hb}, 2Dl{,h,hb}, 1Q, 2Q, Full), KeyCorridor,
LockedRoom, RedBlueDoors, Memory, Playground, the mission families GoToDoor,
Fetch, GoToObject and PutNear, and the 89 BabyAI levels: the 70 whose
mission ``EnvState.target`` decides and the 19 of composite instructions,
whose instructions ``EnvState.instr`` holds. The state of all N
environments lives in tensors with a leading env axis, and
``reset``/``step``/``observe`` are batched functions of them, so the rollout
never leaves the device and no step asks the host anything.
Semantics mirror MiniGrid exactly, as the JAX package does: the integer
encodings, the 7×7 egocentric view with the agent at view cell (3, 6)
facing up, out-of-bounds cells read as grey walls, shadow-casting
visibility where walls are opaque, the action set, the goal reward
``1 - 0.9 * step_count / max_steps``, truncation at ``max_steps``,
DoorKey's door-row quirk of sampling with ``width``, and each family's
success mode (``goal``, ``open_door``, ``pickup_box``, ``pickup_ball``,
``red_then_blue``, ``memory``, ``goto_door``, ``fetch``, ``goto_object``,
``putnear`` and BabyAI's ``babyai_goto``, ``babyai_putnext``,
``babyai_pickup``, ``babyai_open_color``, ``babyai_open``,
``babyai_action`` and ``babyai_seq``, the composite-instruction verifier).
The mission families, Memory and BabyAI keep their episode's target in
``EnvState.target`` (zeros for every other family), and the composite
levels their instructions and verifier latches in ``EnvState.instr`` and
``EnvState.instr_state`` (zeros elsewhere), in the JAX package's layout.

Random draws come from an explicit ``torch.Generator``; the env state holds
no key. The rejection loops of the JAX package run in parallel instead of
one after another: MultiRoom's 64 chain trials (each room's 8 proposals
together, the first that fits taken) and their keep-best rule, and
KeyCorridor's connect loop, whose 256 door proposals are drawn at once and
applied up to the first one after which every room is reachable, as is
the connect loop of BabyAI's mazes; BabyAI's rejection loops (a layout
kept only when ``check_objs_reachable`` passes, an instruction slot kept
only when its description matches some object) draw again only for the
envs or slots whose draw was rejected.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

# --- Integer encodings (MiniGrid-compatible) -------------------------------

UNSEEN, EMPTY, WALL, FLOOR, DOOR, KEY, BALL, BOX, GOAL, LAVA, AGENT = range(11)
RED, GREEN, BLUE, PURPLE, YELLOW, GREY = range(6)
OPEN, CLOSED, LOCKED = range(3)

IDX_TO_OBJECT = {
    UNSEEN: "unseen", EMPTY: "empty", WALL: "wall", FLOOR: "floor",
    DOOR: "door", KEY: "key", BALL: "ball", BOX: "box", GOAL: "goal",
    LAVA: "lava", AGENT: "agent",
}

# dir 0=right(+x), 1=down(+y), 2=left, 3=up
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int64)
DIR_NAMES = ("right", "down", "left", "up")

VIEW_SIZE = 7
_AGENT_VIEW_POS = (VIEW_SIZE // 2, VIEW_SIZE - 1)  # (3, 6)

A_LEFT, A_RIGHT, A_FORWARD, A_PICKUP, A_DROP, A_TOGGLE, A_DONE = range(7)
NUM_ACTIONS = 7

MULTIROOM_TRIALS = 64       # the keep-best loop's cap (`core.py:1228`)
MULTIROOM_PROPOSALS = 8     # proposals per room of one trial
CONNECT_PROPOSALS = 256     # KeyCorridor's connect-loop cap (`core.py:1657`)


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static environment configuration."""

    kind: str  # "empty" | "doorkey" | "fourrooms" | "lavagap" | "multiroom"
    #            | "crossing" | "unlock" | "dynobs" | "distshift" | "redblue"
    #            | "keycorridor" | "lockedroom" | "obstructedfull"
    #            | "playground" | "memory" | "gotodoor" | "fetch"
    #            | "gotoobject" | "putnear" | "babyai_goto" | "babyai_putnext"
    #            | "babyai_pickup" | "babyai_openred" | "babyai_opendoor"
    #            | "babyai_actionobj" | "babyai_gotomaze" | "babyai_unlocklocal"
    #            | "babyai_u2u" | "babyai_objdoor" | "babyai_putnext2"
    #            | "babyai_levelgen" | "babyai_twodoors" | "babyai_pickuploc"
    width: int
    height: int
    max_steps: int
    see_through_walls: bool
    random_start: bool = False  # Empty-Random and Dynamic-Obstacles-Random
    # MultiRoom-N{n}[-S{s}] family; KeyCorridor keeps its rows in
    # min_rooms and its room size in max_room_size.
    min_rooms: int = 0
    max_rooms: int = 0
    max_room_size: int = 0
    # {Simple,Lava}CrossingS{n}N{k} family
    num_crossings: int = 0
    obstacle: int = 0  # WALL (SimpleCrossing) or LAVA (LavaCrossing)
    # Success condition: "goal" (step onto GOAL), "open_door" (a toggle
    # leaves the door open), "pickup_box", "pickup_ball" (of
    # ``target_color`` when it is ≥ 0), "red_then_blue" (the blue door is
    # open after the step; rewarded iff the red one was open before it),
    # or one that reads ``EnvState.target``: "memory", "goto_door",
    # "fetch", "goto_object", "putnear" or BabyAI's "babyai_goto",
    # "babyai_putnext", "babyai_pickup", "babyai_open_color", "babyai_open"
    # and "babyai_action", or "babyai_seq", which reads ``EnvState.instr``
    # (see :func:`step`).
    success: str = "goal"
    strip_row: int = 0         # DistShift: row of the 3-cell lava strip
    blocked_door: bool = False  # a ball blocks the cell left of the locked door
    key_in_box: bool = False    # the key hides in a box (toggle reveals it)
    target_color: int = -1      # pickup_ball's color, −1 = any
    n_obstacles: int = 0        # Dynamic-Obstacles' moving balls
    num_actions: int = NUM_ACTIONS  # 3 for Dynamic-Obstacles
    # Fetch / GoToObject / PutNear: the candidate objects of the mission.
    num_objs: int = 0
    # MemoryS{n}Random: the hallway length is drawn per episode.
    random_length: bool = False
    # ObstructedMaze 2Dl*/1Q/2Q/Full: the (col, row) of the agent's start
    # room; the number of quarters rides ``min_rooms``. The BabyAI maze
    # tier's FindObj/PickupAbove start there too (``fixed_agent_room``).
    agent_room: tuple[int, int] = (0, 0)
    # BabyAI (the JAX package's fields of the same names and defaults).
    grey_dists: bool = False        # GoToRedBallGrey: distractors recolored grey
    strict: bool = False            # PickupDistDebug / OpenDoorDebug: a wrong try fails
    select_by: str = ""             # OpenDoor: "color", "loc" or "" (drawn per episode)
    rb_target: bool = False         # GoToRedBlueBall: a red or blue target ball
    doors_open: bool = False        # GoToOpen / GoToObjMazeOpen: every door opened
    invert_reach: bool = False      # UnblockPickup: some object must be blocked
    fixed_agent_room: bool = False  # FindObj / PickupAbove: the agent starts in agent_room
    type_only: bool = False         # the mission names the type only (color −1)
    obj_room: tuple[int, int] = (-1, -1)  # PickupAbove: the mission object's room
    predoor: tuple[int, int, int] = (-1, -1, -1)  # PickupAbove: a door before connect_all
    start_carrying: bool = False    # PutNext*Carrying: the move object starts in hand
    locked_room: bool = False       # Unlock / GoToImpUnlock: one room behind a LOCKED door
    target_in_locked: bool = False  # GoToImpUnlock: the mission object in the locked room
    dists_per_room: bool = False    # GoToImpUnlock: 2 distractors in each other room
    # BabyAI's composite instructions (the JAX package's fields and defaults).
    locked_room_prob: float = 0.0   # LevelGen: the chance of a locked room per episode
    instr_kinds: str = "action"     # LevelGen grammar: a comma-set of action|and|seq
    action_kinds: str = "goto"      # LevelGen verbs: a comma-set of goto|pickup|open|putnext
    locations: bool = False         # LevelGen: location words are drawn
    check_reachable: bool = False   # GoToSeq: the reachability rejection
    first_color: int = -1           # OpenRedBlueDoors: the forced door colors (−1 random)
    second_color: int = -1
    comp: str = ""                  # OpenTwoDoors "before"; "" draws the mode per episode


@dataclasses.dataclass
class EnvState:
    """Dynamic state of N environments (leading axis = env)."""

    grid: torch.Tensor        # [N, W, H, 3] int8: (object, color, state) per cell
    agent_pos: torch.Tensor   # [N, 2] int64 (x, y)
    agent_dir: torch.Tensor   # [N] int64
    carrying: torch.Tensor    # [N, 3] int8; object == 0 → nothing
    step_count: torch.Tensor  # [N] int32
    # [N, 8] int32 mission target, zeros for the families without one:
    # GoToDoor/GoToObject [obj, color, x, y, 0…]; Fetch [obj, color, 0…];
    # PutNear [move_obj, move_color, near_obj, near_color, near_x, near_y,
    # 0, 0]; Memory [sx, sy, fx, fy, 0…] (the success and failure cells);
    # BabyAI GoTo/Pickup/Open [obj, color, 0…] (−1 a wildcard), PutNext
    # [move_obj, move_color, fixed_obj, fixed_color, 0…], OpenRedDoor and
    # OpenDoor the matched doors' x·height + y + 1 in [:4], ActionObjDoor
    # [verb, obj, color, 0…]; the composite levels [comp, seq_strict, 0…]
    # (see ``instr``).
    target: torch.Tensor
    # [N, 4, 12] int32 BabyAI composite instructions, zeros for every other
    # family: up to 4 atomic instructions, a row each: [verb (0 unused,
    # 1 goto, 2 open, 3 pickup, 4 putnext), type_a, color_a, type_b,
    # color_b (putnext's fixed object), flags (bit 0 a positional match
    # set, bit 1 strict), p0..p5 (the match set's packed positions
    # x·height + y + 1, 0 empty)]; −1 is a wildcard. ``target[0]`` composes
    # them (0 slot 0 alone, 1 and(0, 1), 2 before(A, B), 3 after(A, B) with
    # A = slots 0-1 and B = slots 2-3) and ``target[1]`` is the SeqInstr
    # strict bit.
    instr: torch.Tensor
    # [N, 4, 2] int32 verifier state per slot: its done latch, and the packed
    # position a tracked object was picked up from (0 none).
    instr_state: torch.Tensor


def _maze(kind: str, side: int, s: int, rows: int, success: str, num_objs: int,
          **kw) -> EnvParams:
    """A BabyAI ``rows`` × ``rows`` RoomGrid of ``s``×``s`` rooms, max_steps
    8·s² (RoomGrid's default)."""
    return EnvParams(kind, side, side, 8 * s * s, False, success=success, num_objs=num_objs,
                     min_rooms=rows, max_rooms=rows, max_room_size=s, **kw)


def _parse_babyai(env_id: str) -> Optional[EnvParams]:
    """The 89 BabyAI ids, parsed as the JAX
    package's ``parse_env_id`` parses them (its comments give each level's
    upstream source); None for any other id. BabyAI grids are opaque
    (``see_through_walls=False``)."""
    m = re.match(r"BabyAI-GoToRedBall(Grey|NoDists)?(-v\d+)?$", env_id)
    if m:
        # one 8×8 room: the red ball and 7 random distractors (grey in
        # Grey, none in NoDists); GoToInstr(red ball)
        return EnvParams("babyai_goto", 8, 8, 8 * 8 * 8, False, success="babyai_goto",
                         num_objs=0 if m.group(1) == "NoDists" else 7,
                         grey_dists=m.group(1) == "Grey", target_color=RED)
    if re.match(r"BabyAI-GoToRedBlueBall(-v\d+)?$", env_id):
        # a red or blue target ball and 7 distractors that are no red or
        # blue ball
        return EnvParams("babyai_goto", 8, 8, 8 * 8 * 8, False, success="babyai_goto",
                         num_objs=7, rb_target=True)
    if re.match(r"BabyAI-OpenRedDoor(-v\d+)?$", env_id):
        # two 5×5 rooms (9×5), a red door between them; OpenInstr(red door)
        return EnvParams("babyai_openred", 9, 5, 8 * 5 * 5, False, success="babyai_open")
    m = re.match(r"BabyAI-OpenDoor(Color|Loc)?(Debug)?(-v\d+)?$", env_id)
    if m:
        # a 3×3 RoomGrid of 8×8 rooms, four doors on the center room named
        # by color or by a location word; Debug fails a wrong toggle
        return EnvParams("babyai_opendoor", 22, 22, 8 * 8 * 8, False, success="babyai_open",
                         select_by=(m.group(1) or "").lower(), strict=m.group(2) is not None)
    if re.match(r"BabyAI-ActionObjDoor(-v\d+)?$", env_id):
        # 3×3 rooms of 7×7: 5 distinct objects and 4 doors in the center
        # room; goto / pickup / open per episode
        return EnvParams("babyai_actionobj", 19, 19, 8 * 7 * 7, False,
                         success="babyai_action", num_objs=5)
    m = re.match(r"BabyAI-GoTo(Open)?(-v\d+)?$", env_id)
    if m:
        # 3×3 rooms of 8×8, connect_all doors (opened in GoToOpen), 18
        # distractors, reachability rejection; GoToInstr on one
        return _maze("babyai_gotomaze", 22, 8, 3, "babyai_goto", 18,
                     doors_open=m.group(1) is not None)
    m = re.match(r"BabyAI-GoToObjMaze(Open)?(?:S(\d+)(R2)?)?(-v\d+)?$", env_id)
    if m:
        # the GoTo maze with one object; S{n} rooms of n×n, R2 2×2 rooms
        s, rows = int(m.group(2) or 8), 2 if m.group(3) else 3
        return _maze("babyai_gotomaze", (s - 1) * rows + 1, s, rows, "babyai_goto", 1,
                     doors_open=m.group(1) is not None)
    if re.match(r"BabyAI-Open(-v\d+)?$", env_id):
        # the GoTo maze; OpenInstr on the color of a uniform door
        return _maze("babyai_gotomaze", 22, 8, 3, "babyai_open_color", 18)
    m = re.match(r"BabyAI-(Unblock)?Pickup(-v\d+)?$", env_id)
    if m:
        # the GoTo maze with PickupInstr; UnblockPickup's 20 objects keep
        # only layouts where some object is blocked
        unblock = m.group(1) is not None
        return _maze("babyai_gotomaze", 22, 8, 3, "babyai_pickup", 20 if unblock else 18,
                     invert_reach=unblock)
    if re.match(r"BabyAI-Unlock(-v\d+)?$", env_id):
        # the GoTo maze with one room behind a LOCKED door, its key in
        # another room; OpenInstr on the locked door's color
        return _maze("babyai_gotomaze", 22, 8, 3, "babyai_open_color", 18, locked_room=True)
    m = re.match(r"BabyAI-UnlockLocal(Dist)?(-v\d+)?$", env_id)
    if m:
        # a locked door and its key in the center room (Dist: 3 distinct
        # distractors); OpenInstr(door), type only
        return EnvParams("babyai_unlocklocal", 22, 22, 8 * 8 * 8, False,
                         success="babyai_open_color", num_objs=3 if m.group(1) else 0)
    if re.match(r"BabyAI-KeyInBox(-v\d+)?$", env_id):
        # UnlockLocal with the key hidden in a box
        return EnvParams("babyai_unlocklocal", 22, 22, 8 * 8 * 8, False,
                         success="babyai_open_color", key_in_box=True)
    m = re.match(r"BabyAI-UnlockPickup(Dist)?(-v\d+)?$", env_id)
    if m:
        # MiniGrid-UnlockPickup's layout; Dist adds 4 distinct distractors,
        # so the box's color decides (PickupInstr)
        if m.group(1):
            return EnvParams("unlock", 11, 6, 8 * 6 * 6, False, success="babyai_pickup",
                             num_objs=4)
        return EnvParams("unlock", 11, 6, 8 * 6 * 6, False, success="pickup_box")
    if re.match(r"BabyAI-BlockedUnlockPickup(-v\d+)?$", env_id):
        # MiniGrid-BlockedUnlockPickup's layout
        return EnvParams("unlock", 11, 6, 16 * 6 * 6, False, success="pickup_box",
                         blocked_door=True)
    if re.match(r"BabyAI-UnlockToUnlock(-v\d+)?$", env_id):
        # three 6×6 rooms, two locked doors with crossed keys, the ball in
        # the far room; PickupInstr(ball), type only
        return EnvParams("babyai_u2u", 16, 6, 30 * 6 * 6, False, success="babyai_pickup")
    if re.match(r"BabyAI-GoToImpUnlock(-v\d+)?$", env_id):
        # the Unlock maze, 2 distractors in each other room and the
        # GoToInstr object inside the locked room
        return _maze("babyai_gotomaze", 22, 8, 3, "babyai_goto", 16, locked_room=True,
                     target_in_locked=True, dists_per_room=True)
    m = re.match(r"BabyAI-OneRoomS(\d+)(-v\d+)?$", env_id)
    if m:
        # one s×s room holding one ball of a random color; PickupInstr(ball)
        size = int(m.group(1))
        return EnvParams("babyai_goto", size, size, 8 * size * size, False,
                         success="babyai_pickup", num_objs=0, type_only=True)
    m = re.match(r"BabyAI-FindObjS(\d+)(-v\d+)?$", env_id)
    if m:
        # 3×3 rooms of s×s, one object in a random room, the agent in the
        # middle room; PickupInstr on its type
        s = int(m.group(1))
        return _maze("babyai_gotomaze", (s - 1) * 3 + 1, s, 3, "babyai_pickup", 1,
                     fixed_agent_room=True, agent_room=(1, 1), type_only=True)
    if re.match(r"BabyAI-PickupAbove(-v\d+)?$", env_id):
        # the object in the room above the middle one, a door on the middle
        # room's top wall; PickupInstr on its type
        return _maze("babyai_gotomaze", 22, 8, 3, "babyai_pickup", 1, fixed_agent_room=True,
                     agent_room=(1, 1), obj_room=(1, 0), predoor=(1, 1, 3), type_only=True)
    if re.match(r"BabyAI-GoToDoor(-v\d+)?$", env_id):
        # 3×3 rooms of 7×7, four random-color doors on the center room;
        # GoToInstr on a door's color
        return EnvParams("babyai_objdoor", 19, 19, 8 * 7 * 7, False, success="babyai_goto",
                         num_objs=0, max_room_size=7)
    if re.match(r"BabyAI-GoToObjDoor(-v\d+)?$", env_id):
        # 3×3 rooms of 6×6, 8 distractors and 4 doors in the center room
        return EnvParams("babyai_objdoor", 16, 16, 8 * 6 * 6, False, success="babyai_goto",
                         num_objs=8, max_room_size=6)
    m = re.match(r"BabyAI-PutNextS(\d+)N(\d+)(Carrying)?(-v\d+)?$", env_id)
    if m:
        # two s×s rooms without their dividing wall, n distinct objects a
        # side; put a left one next to a right one, or the other way round
        s, k = int(m.group(1)), int(m.group(2))
        return EnvParams("babyai_putnext2", 2 * s - 1, s, 8 * s * s, False,
                         success="babyai_putnext", num_objs=k, max_room_size=s,
                         start_carrying=m.group(3) is not None)
    m = re.match(r"BabyAI-MoveTwoAcrossS(\d+)N(\d+)(-v\d+)?$", env_id)
    if m:
        # the PutNext layout; before(put a left object next to a right one,
        # put a right object next to a left one)
        s, k = int(m.group(1)), int(m.group(2))
        return EnvParams("babyai_putnext2", 2 * s - 1, s, 16 * s * s, False,
                         success="babyai_seq", num_objs=k, max_room_size=s)
    m = re.match(r"BabyAI-Open(RedBlue|Two)Doors(Debug)?(-v\d+)?$", env_id)
    if m:
        # the 6×6 center room of a 3×3 RoomGrid, door 1 west and door 2 east;
        # before(open door 1, strict in Debug; open door 2), red then blue
        # in RedBlue
        rb = m.group(1) == "RedBlue"
        return EnvParams("babyai_twodoors", 16, 16, 20 * 6 * 6, False, success="babyai_seq",
                         comp="before", first_color=RED if rb else -1,
                         second_color=BLUE if rb else -1, strict=m.group(2) is not None)
    m = re.match(r"BabyAI-OpenDoorsOrderN(\d+)(Debug)?(-v\d+)?$", env_id)
    if m:
        # n doors of distinct colors on distinct walls of the center room;
        # open door 1, or door 1 before or after door 2, drawn per episode
        return EnvParams("babyai_twodoors", 16, 16, 20 * 6 * 6, False, success="babyai_seq",
                         num_objs=int(m.group(1)), strict=m.group(2) is not None)
    if re.match(r"BabyAI-PickupLoc(-v\d+)?$", env_id):
        # one 8×8 room, 8 random objects; PickupInstr on a description drawn
        # until it matches, a location word in half of them
        return EnvParams("babyai_pickuploc", 8, 8, 8 * 8 * 8, False, success="babyai_seq",
                         num_objs=8)
    m = re.match(r"BabyAI-GoToSeq(S5R2)?(-v\d+)?$", env_id)
    if m:
        # LevelGen: goto only, every grammar, no locked room, reachability
        # rejection; S5R2 2×2 rooms of 5
        s, rows, k = (5, 2, 7) if m.group(1) else (8, 3, 18)
        return _maze("babyai_levelgen", (s - 1) * rows + 1, s, rows, "babyai_seq", k,
                     instr_kinds="action,and,seq", action_kinds="goto", check_reachable=True)
    m = re.match(r"BabyAI-Synth(S5R2|Loc|Seq)?(-v\d+)?$", env_id)
    if m:
        # LevelGen over the four verbs, a locked room half the time; Loc adds
        # location words, Seq the and/seq grammar with them
        v = m.group(1) or ""
        s, rows, k = (5, 2, 7) if v == "S5R2" else (8, 3, 18)
        return _maze("babyai_levelgen", (s - 1) * rows + 1, s, rows, "babyai_seq", k,
                     locked_room_prob=0.5, instr_kinds="action,and,seq" if v == "Seq" else "action",
                     action_kinds="goto,pickup,open,putnext", locations=v in ("Loc", "Seq"))
    m = re.match(r"BabyAI-(Mini)?BossLevel(NoUnlock)?(-v\d+)?$", env_id)
    if m:
        # LevelGen's whole grammar with location words; MiniBoss 2×2 rooms of
        # 5, 7 distractors, a locked room a quarter of the time; Boss 3×3 of
        # 8, 18, half the time (never in NoUnlock)
        mini = m.group(1) is not None
        s, rows, k = (5, 2, 7) if mini else (8, 3, 18)
        return _maze("babyai_levelgen", (s - 1) * rows + 1, s, rows, "babyai_seq", k,
                     locked_room_prob=0.25 if mini else (0.0 if m.group(2) else 0.5),
                     instr_kinds="action,and,seq", action_kinds="goto,pickup,open,putnext",
                     locations=True)
    m = re.match(r"BabyAI-GoToObj(?:S(\d+))?(-v\d+)?$", env_id)
    if m:
        # one room, one random object; GoToInstr on it
        size = int(m.group(1) or 8)
        return EnvParams("babyai_goto", size, size, 8 * size * size, False,
                         success="babyai_goto", num_objs=1)
    m = re.match(r"BabyAI-GoToLocal(?:S(\d+)N(\d+))?(-v\d+)?$", env_id)
    if m:
        # one s×s room, n random objects (duplicates allowed); GoToInstr on one
        size, k = int(m.group(1) or 8), int(m.group(2) or 8)
        return EnvParams("babyai_goto", size, size, 8 * size * size, False,
                         success="babyai_goto", num_objs=k)
    m = re.match(r"BabyAI-PutNextLocal(?:S(\d+)N(\d+))?(-v\d+)?$", env_id)
    if m:
        # one s×s room, n distinct objects; put one next to another
        size, k = int(m.group(1) or 8), int(m.group(2) or 8)
        return EnvParams("babyai_putnext", size, size, 8 * size * size, False,
                         success="babyai_putnext", num_objs=k)
    m = re.match(r"BabyAI-PickupDist(Debug)?(-v\d+)?$", env_id)
    if m:
        # one 7×7 room, 5 distinct objects, the mission by type, color or
        # both; Debug fails a wrong pickup
        return EnvParams("babyai_pickup", 7, 7, 8 * 7 * 7, False, success="babyai_pickup",
                         num_objs=5, strict=m.group(1) is not None)
    return None


def parse_env_id(env_id: str) -> EnvParams:
    """Map a MiniGrid env id to EnvParams.

    Runs ``Empty[-Random]-NxN``, ``DoorKey-NxN``, ``FourRooms``,
    ``LavaGapSn``, ``DistShift{1,2}``, ``MultiRoom-Nn[-Ss]``,
    ``{Simple,Lava}CrossingSsNn``, ``Dynamic-Obstacles[-Random]-NxN``,
    ``Unlock``, ``UnlockPickup``, ``BlockedUnlockPickup``,
    ``ObstructedMaze-1Dl{,h,hb}``, ``ObstructedMaze-2Dl{,h,hb}``,
    ``ObstructedMaze-{1Q,2Q,Full}``, ``Playground``, ``KeyCorridorSsRr``,
    ``LockedRoom``, ``RedBlueDoors-NxN``, ``MemoryS{n}[Random]``,
    ``GoToDoor-NxN``, ``Fetch-NxN-Nk``, ``GoToObject-NxN-Nk`` and
    ``PutNear-NxN-Nk`` (each with an optional -vK suffix), and the BabyAI
    levels ``GoToRedBall{,Grey,NoDists}``, ``GoToRedBlueBall``,
    ``GoToObj[Ss]``, ``GoToLocal[SsNn]``, ``OneRoomS{n}``,
    ``PutNextLocal[SsNn]``, ``PickupDist[Debug]``, ``OpenRedDoor``,
    ``OpenDoor[Color|Loc][Debug]``, ``ActionObjDoor``, ``GoTo[Open]``,
    ``GoToObjMaze[Open|S{n}[R2]]``, ``Pickup``, ``UnblockPickup``, ``Open``,
    ``Unlock``, ``GoToImpUnlock``, ``FindObjS{n}``, ``PickupAbove``,
    ``UnlockLocal[Dist]``, ``KeyInBox``, ``UnlockToUnlock``, ``GoToDoor``,
    ``GoToObjDoor``, ``PutNextS{s}N{n}[Carrying]``, ``UnlockPickup[Dist]``,
    ``BlockedUnlockPickup`` and the levels of composite instructions
    ``GoToSeq[S5R2]``, ``Synth[S5R2|Loc|Seq]``, ``[Mini]BossLevel[NoUnlock]``,
    ``MoveTwoAcrossS{s}N{n}``, ``Open{Two,RedBlue}Doors[Debug]``,
    ``OpenDoorsOrderN{n}[Debug]`` and ``PickupLoc``.
    """
    m = re.match(r"MiniGrid-DistShift(1|2)(-v\d+)?$", env_id)
    if m:
        # DistShiftEnv(width=9, height=7, strip2_row=2|5): 3-cell lava
        # strip at x ∈ [3, 5] in row 2 (DistShift1) or 5 (DistShift2),
        # goal at (width-2, 1), agent (1,1) facing right; deterministic
        # layout, max_steps = 4·width², see_through_walls=True (upstream
        # minigrid/envs/distshift.py).
        return EnvParams("distshift", 9, 7, 4 * 9 * 9, True,
                         strip_row=2 if m.group(1) == "1" else 5)
    m = re.match(r"MiniGrid-RedBlueDoors-(\d+)x(\d+)(-v\d+)?$", env_id)
    if m:
        # RedBlueDoorEnv(size): 2size×size grid; a size×size room in the
        # middle (wall_rect(size//2, 0, size, size)) with a red door at a
        # random y on its left wall and a blue door on its right wall;
        # agent placed randomly inside the room. Success = opening the
        # blue door while the red door is already open (upstream
        # redbluedoors.py step()); max_steps = 20·size² (registered
        # 6x6 and 8x8).
        size = int(m.group(1))
        if size != int(m.group(2)):
            raise ValueError("only square RedBlueDoors rooms are supported")
        return EnvParams("redblue", 2 * size, size, 20 * size * size, False,
                         success="red_then_blue")
    m = re.match(r"MiniGrid-MultiRoom-N(\d+)(?:-S(\d+))?(-v\d+)?$", env_id)
    if m:
        # MultiRoomEnv(minNumRooms=n, maxNumRooms=n, maxRoomSize=s or 10):
        # 25×25 grid, max_steps = maxNumRooms·20 (upstream multiroom.py;
        # registered ids N2-S4, N4-S5, N6).
        n = int(m.group(1))
        s = int(m.group(2)) if m.group(2) else 10
        return EnvParams("multiroom", 25, 25, n * 20, False,
                         min_rooms=n, max_rooms=n, max_room_size=s)
    m = re.match(r"MiniGrid-(Simple|Lava)CrossingS(\d+)N(\d+)(-v\d+)?$", env_id)
    if m:
        # CrossingEnv(size, num_crossings, obstacle_type=Wall|Lava):
        # max_steps = 4·size² (upstream crossing.py; registered sizes
        # S9N{1,2,3} and S11N5).
        size = int(m.group(2))
        return EnvParams("crossing", size, size, 4 * size * size, False,
                         num_crossings=int(m.group(3)),
                         obstacle=WALL if m.group(1) == "Simple" else LAVA)
    m = re.match(r"MiniGrid-Dynamic-Obstacles(-Random)?-(\d+)x(\d+)(-v\d+)?$", env_id)
    if m:
        # DynamicObstaclesEnv(size, agent_start_pos=(1,1)|None,
        # n_obstacles=size//2): size//2 moving balls; restricted 3-action
        # space (left/right/forward); max_steps = 4·size²,
        # see_through_walls=True (upstream dynamicobstacles.py; registered
        # [Random-]{5x5,6x6,8x8,16x16}).
        size = int(m.group(2))
        if size != int(m.group(3)):
            raise ValueError("only square grids are supported")
        return EnvParams("dynobs", size, size, 4 * size * size, True,
                         random_start=m.group(1) is not None,
                         n_obstacles=size // 2, num_actions=3)
    m = re.match(r"MiniGrid-KeyCorridorS(\d+)R(\d+)(-v\d+)?$", env_id)
    if m:
        # KeyCorridorEnv(room_size=s, num_rows=r): RoomGrid(3 columns ×
        # r rows of s×s rooms) → ((s-1)·3+1) × ((s-1)·r+1) grid; the
        # middle column is opened into a corridor, a LOCKED random-color
        # door hides a ball in a random right-column room, the matching
        # key sits in a random left-column room, the agent starts in the
        # middle, and connect_all() adds doors until every room is
        # reachable. Success = picking the ball up
        # (upstream minigrid/envs/keycorridor.py; max_steps = 30·s²;
        # registered S3R{1,2,3}, S{4,5,6}R3).
        s, r = int(m.group(1)), int(m.group(2))
        return EnvParams("keycorridor", (s - 1) * 3 + 1, (s - 1) * r + 1, 30 * s * s,
                         False, min_rooms=r, max_room_size=s, success="pickup_ball")
    if re.match(r"MiniGrid-Unlock(-v\d+)?$", env_id):
        # UnlockEnv: RoomGrid(room_size=6, rows=1, cols=2) → 11×6 grid,
        # locked random-color door on the dividing wall, matching key and
        # agent placed in the left room; success = toggling the door open
        # (upstream unlock.py; max_steps = 8·room_size²).
        return EnvParams("unlock", 11, 6, 8 * 6 * 6, False, success="open_door")
    if re.match(r"MiniGrid-UnlockPickup(-v\d+)?$", env_id):
        # UnlockPickupEnv: the Unlock layout plus a random-color box in
        # the right room; success = picking the box up (upstream
        # unlockpickup.py; max_steps = 8·room_size²).
        return EnvParams("unlock", 11, 6, 8 * 6 * 6, False, success="pickup_box")
    m = re.match(r"MiniGrid-ObstructedMaze-1Dl(h?)(b?)(-v\d+)?$", env_id)
    if m:
        # ObstructedMaze_1Dl{,h,hb}: RoomGrid(room_size=6, 1×2 rooms) —
        # the Unlock layout with the target BLUE ball in the right room;
        # "h" hides the key inside a box (toggle reveals it), "b" blocks
        # the locked door with a non-blue ball (the -v1 bugfix colors —
        # v0's blue blocker was indistinguishable from the target).
        # Success = picking the blue ball up; max_steps =
        # 4·num_rooms_visited·room_size² = 288 (upstream
        # minigrid/envs/obstructedmaze.py).
        return EnvParams("unlock", 11, 6, 4 * 2 * 36, False, success="pickup_ball",
                         target_color=BLUE, key_in_box=m.group(1) == "h",
                         blocked_door=m.group(2) == "b")
    m = re.match(r"MiniGrid-ObstructedMaze-2Dl(h?)(b?)(-v\d+)?$", env_id)
    if m:
        # ObstructedMaze_2Dl{,h,hb}: the Full maze restricted to one
        # quarter with the agent starting in the side room (2, 1) —
        # upstream ObstructedMaze_Full((2, 1), key_in_box, blocked,
        # num_quarters=1, num_rooms_visited=4); max_steps =
        # 4·num_rooms_visited·room_size² = 576 (upstream
        # minigrid/envs/obstructedmaze.py).
        return EnvParams("obstructedfull", 16, 16, 4 * 4 * 36, False, success="pickup_ball",
                         target_color=BLUE, key_in_box=m.group(1) == "h",
                         blocked_door=m.group(2) == "b", min_rooms=1, agent_room=(2, 1))
    m = re.match(r"MiniGrid-ObstructedMaze-(1Q|2Q|Full)(-v\d+)?$", env_id)
    if m:
        # ObstructedMaze_{1Q,2Q,Full}: a 3×3 RoomGrid of 6×6 rooms; the
        # agent starts in the middle room, which opens onto
        # ``num_quarters`` side rooms; each side room has two LOCKED doors
        # toward its corners with the keys hidden in boxes and the doors
        # blocked by balls; the target BLUE ball sits in one of the first
        # ``num_quarters`` corner rooms. max_steps =
        # 4·num_rooms_visited·room_size² with num_rooms_visited
        # ∈ {1Q: 5, 2Q: 11, Full: 25} (upstream obstructedmaze.py).
        q = {"1Q": 1, "2Q": 2, "Full": 4}[m.group(1)]
        visited = {"1Q": 5, "2Q": 11, "Full": 25}[m.group(1)]
        return EnvParams("obstructedfull", 16, 16, 4 * visited * 36, False,
                         success="pickup_ball", target_color=BLUE, key_in_box=True,
                         blocked_door=True, min_rooms=q, agent_room=(1, 1))
    if re.match(r"MiniGrid-Playground(-v\d+)?$", env_id):
        # PlaygroundEnv: 19×19 split into 3×3 rooms of 6×6, one CLOSED
        # random-color door per internal wall segment (12 doors), twelve
        # random key/ball/box objects of random colors, random agent
        # start. No goal and no reward — episodes only truncate at
        # max_steps=100 (upstream minigrid/envs/playground.py).
        return EnvParams("playground", 19, 19, 100, False)
    if re.match(r"MiniGrid-BlockedUnlockPickup(-v\d+)?$", env_id):
        # BlockedUnlockPickupEnv: UnlockPickup plus a random-color ball
        # placed directly left of the locked door — the agent must move
        # it aside before unlocking (upstream blockedunlockpickup.py;
        # max_steps = 16·room_size²).
        return EnvParams("unlock", 11, 6, 16 * 6 * 6, False, success="pickup_box",
                         blocked_door=True)
    if re.match(r"MiniGrid-FourRooms(-v\d+)?$", env_id):
        # FourRoomsEnv: 19×19, four rooms with one random gap per shared
        # wall segment, random agent + goal, max_steps=100 (the env the
        # reference's eval configs reference, `evaluate_algorithm.py:30`).
        return EnvParams("fourrooms", 19, 19, 100, False, True)
    m = re.match(r"MiniGrid-LavaGapS(\d+)(-v\d+)?$", env_id)
    if m:
        # LavaGapEnv(size): full-height lava column at a random x with a
        # single gap; agent (1,1) facing right, goal bottom-right,
        # max_steps = 4·size², see_through_walls=False (upstream
        # minigrid lavagap.py; S5/S6/S7 are the registered sizes).
        size = int(m.group(1))
        return EnvParams("lavagap", size, size, 4 * size * size, False)
    if re.match(r"MiniGrid-LockedRoom(-v\d+)?$", env_id):
        # LockedRoomEnv(size=19): a central hallway flanked by 2×3 rooms;
        # one room is locked and holds the goal, the key (of the locked
        # door's color) lies in another room; the agent starts in the
        # hallway. max_steps = 10·size, see_through_walls=False (upstream
        # minigrid/envs/lockedroom.py — reconstructed; only size 19 is
        # registered).
        return EnvParams("lockedroom", 19, 19, 10 * 19, False)
    m = re.match(r"MiniGrid-MemoryS(\d+)(Random)?(-v\d+)?$", env_id)
    if m:
        # MemoryEnv(size): the agent starts in a small room holding one
        # green key-or-ball, walks a hallway, and must step onto the cell
        # in front of the matching object at the fork (the wrong side
        # terminates with 0); the two cells live in EnvState.target.
        # max_steps = 5·size², see_through_walls=False (upstream
        # minigrid/envs/memory.py). Registered: S7, S9, S11, S13,
        # S13Random, S17Random.
        size = int(m.group(1))
        if size % 2 != 1 or size < 7:
            raise ValueError("Memory needs an odd size of at least 7")
        return EnvParams("memory", size, size, 5 * size * size, False,
                         random_length=bool(m.group(2)), success="memory")
    m = re.match(r"MiniGrid-GoToDoor-(\d+)x(\d+)(-v\d+)?$", env_id)
    if m:
        # GoToDoorEnv(size): the room's width and height are drawn per
        # episode in [5, size]; four CLOSED doors of distinct colors, one
        # per wall; the mission names one of them and ``done`` next to it
        # earns the time-scaled reward; any toggle ends the episode.
        # max_steps = 4·size², see_through_walls=True (upstream
        # minigrid/envs/gotodoor.py). Registered: 5x5, 6x6, 8x8.
        size = int(m.group(1))
        if size != int(m.group(2)) or size < 5:
            raise ValueError("GoToDoor needs a square grid of size at least 5")
        return EnvParams("gotodoor", size, size, 4 * size * size, True, success="goto_door")
    m = re.match(r"MiniGrid-Fetch-(\d+)x(\d+)-N(\d+)(-v\d+)?$", env_id)
    if m:
        # FetchEnv(size, numObjs): numObjs keys/balls of random colors
        # (duplicate type+color pairs allowed); the mission names one
        # (type, color) and picking ANY object ends the episode, with the
        # time-scaled reward iff it matches. max_steps = 5·size²,
        # see_through_walls=True (upstream fetch.py). Registered: 5x5-N2,
        # 6x6-N2, 8x8-N3.
        size = int(m.group(1))
        if size != int(m.group(2)):
            raise ValueError("only square Fetch grids are supported")
        return EnvParams("fetch", size, size, 5 * size * size, True, success="fetch",
                         num_objs=int(m.group(3)))
    m = re.match(r"MiniGrid-GoToObject-(\d+)x(\d+)-N(\d+)(-v\d+)?$", env_id)
    if m:
        # GoToObjectEnv(size, numObjs): numObjs distinct (type, color)
        # key/ball/box objects; ``done`` within Chebyshev distance 1 of the
        # mission's target earns the time-scaled reward and ends the
        # episode either way. max_steps = 5·size², see_through_walls=True
        # (upstream gotoobject.py). Registered: 6x6-N2, 8x8-N2.
        size = int(m.group(1))
        if size != int(m.group(2)):
            raise ValueError("only square GoToObject grids are supported")
        return EnvParams("gotoobject", size, size, 5 * size * size, True,
                         success="goto_object", num_objs=int(m.group(3)))
    m = re.match(r"MiniGrid-PutNear-(\d+)x(\d+)-N(\d+)(-v\d+)?$", env_id)
    if m:
        # PutNearEnv(size, numObjs): numObjs distinct (type, color)
        # key/ball/box objects, no two adjacent; the mission asks to put
        # object A near object B — dropping A within Chebyshev distance 1
        # of B earns the time-scaled reward; any drop of a carried object
        # ends the episode, as does picking up the wrong object.
        # max_steps = 5·size (a short horizon), see_through_walls=True
        # (upstream putnear.py). Registered: 6x6-N2, 8x8-N3.
        size = int(m.group(1))
        if size != int(m.group(2)):
            raise ValueError("only square PutNear grids are supported")
        return EnvParams("putnear", size, size, 5 * size, True, success="putnear",
                         num_objs=int(m.group(3)))
    babyai = _parse_babyai(env_id)
    if babyai is not None:
        return babyai
    m = re.match(r"MiniGrid-(Empty|DoorKey)(-Random)?-(\d+)x(\d+)(-v\d+)?$", env_id)
    if m:
        kind = m.group(1).lower()
        size = int(m.group(3))
        if size != int(m.group(4)):
            raise ValueError("only square grids are supported")
        if kind == "empty":
            # EmptyEnv: max_steps = 4 * size**2, see_through_walls=True.
            return EnvParams("empty", size, size, 4 * size * size, True, m.group(2) is not None)
        # DoorKeyEnv: max_steps = 10 * size**2, see_through_walls=False.
        return EnvParams("doorkey", size, size, 10 * size * size, False)
    raise ValueError(
        f"unsupported MiniGrid env id: {env_id!r}. The port runs "
        "MiniGrid-Empty[-Random]-NxN, MiniGrid-DoorKey-NxN, MiniGrid-FourRooms, "
        "MiniGrid-LavaGapSn, MiniGrid-DistShift{1,2}, MiniGrid-MultiRoom-Nn[-Ss], "
        "MiniGrid-{Simple,Lava}CrossingSsNn, MiniGrid-Dynamic-Obstacles[-Random]-NxN, "
        "MiniGrid-Unlock, MiniGrid-UnlockPickup, MiniGrid-BlockedUnlockPickup, "
        "MiniGrid-ObstructedMaze-{1Dl,2Dl}{,h,hb}, MiniGrid-ObstructedMaze-{1Q,2Q,Full}, "
        "MiniGrid-Playground, MiniGrid-KeyCorridorSsRr, MiniGrid-LockedRoom, "
        "MiniGrid-RedBlueDoors-NxN, MiniGrid-MemoryS{n}[Random], MiniGrid-GoToDoor-NxN, "
        "MiniGrid-Fetch-NxN-Nk, MiniGrid-GoToObject-NxN-Nk, MiniGrid-PutNear-NxN-Nk, "
        "BabyAI-GoToRedBall{,Grey,NoDists}, BabyAI-GoToRedBlueBall, BabyAI-GoToObj[Ss], "
        "BabyAI-GoToLocal[SsNn], BabyAI-OneRoomSn, BabyAI-PutNextLocal[SsNn], "
        "BabyAI-PickupDist[Debug], BabyAI-OpenRedDoor, BabyAI-OpenDoor[Color|Loc][Debug], "
        "BabyAI-ActionObjDoor, BabyAI-GoTo[Open], BabyAI-GoToObjMaze[Open|Sn[R2]], "
        "BabyAI-Pickup, BabyAI-UnblockPickup, BabyAI-Open, BabyAI-Unlock, "
        "BabyAI-GoToImpUnlock, BabyAI-FindObjSn, BabyAI-PickupAbove, "
        "BabyAI-UnlockLocal[Dist], BabyAI-KeyInBox, BabyAI-UnlockToUnlock, BabyAI-GoToDoor, "
        "BabyAI-GoToObjDoor, BabyAI-PutNextSsNn[Carrying], BabyAI-UnlockPickup[Dist], "
        "BabyAI-BlockedUnlockPickup, BabyAI-GoToSeq[S5R2], BabyAI-Synth[S5R2|Loc|Seq], "
        "BabyAI-[Mini]BossLevel[NoUnlock], BabyAI-MoveTwoAcrossSsNn, "
        "BabyAI-Open{Two,RedBlue}Doors[Debug], BabyAI-OpenDoorsOrderNn[Debug] and "
        "BabyAI-PickupLoc (each with an optional -vK suffix)."
    )


# ---------------------------------------------------------------------------
# Reset
# ---------------------------------------------------------------------------


def _cell(obj, color, state, device) -> torch.Tensor:
    """One [3] int8 cell, or [N, 3] where any of the three is an [N] tensor."""
    parts = [torch.as_tensor(v, device=device).to(torch.int8) for v in (obj, color, state)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def _coords(w: int, h: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[1, W, 1] x and [1, 1, H] y coordinates."""
    return (torch.arange(w, device=device).reshape(1, w, 1),
            torch.arange(h, device=device).reshape(1, 1, h))


def _at(xs: torch.Tensor, ys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[N, W, H] mask of the cell ``pos`` [N, 2] of each env."""
    return (xs == pos[:, 0].reshape(-1, 1, 1)) & (ys == pos[:, 1].reshape(-1, 1, 1))


def _base_grid(params: EnvParams, n: int, device, goal: bool = True) -> torch.Tensor:
    """[N, W, H, 3] bordered empty grids, with the goal in the bottom-right
    interior cell unless ``goal`` is false."""
    w, h = params.width, params.height
    grid = np.zeros((w, h, 3), dtype=np.int8)
    grid[..., 0] = EMPTY
    grid[0, :, :] = [WALL, GREY, 0]
    grid[w - 1, :, :] = [WALL, GREY, 0]
    grid[:, 0, :] = [WALL, GREY, 0]
    grid[:, h - 1, :] = [WALL, GREY, 0]
    if goal:
        grid[w - 2, h - 2, :] = [GOAL, GREEN, 0]
    return torch.as_tensor(grid, device=device).expand(n, w, h, 3).clone()


def _sample_free_cell(free: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One uniform cell among ``free`` [N, W, H] per env → [N, 2] (x, y).
    An env with no free cell gets cell (0, 0), as the JAX package's
    categorical over all −inf logits does."""
    n, _, h = free.shape
    weights = free.reshape(n, -1).float()
    weights[:, 0] += weights.sum(1) == 0
    idx = torch.multinomial(weights, 1, generator=gen)[:, 0]
    return torch.stack([idx // h, idx % h], dim=-1)


def _randint(lo: int, hi: int, n, gen: torch.Generator, device) -> torch.Tensor:
    shape = (n,) if isinstance(n, int) else tuple(n)
    return torch.randint(lo, hi, shape, generator=gen, device=device)


def _rand_between(lo: torch.Tensor, hi: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Uniform integers in [lo, hi) elementwise (lo where hi <= lo)."""
    span = (hi - lo).clamp_min(1)
    u = torch.rand(span.shape, generator=gen, device=span.device)
    return lo + torch.minimum((u * span).long(), span - 1)


def _state(grid, agent_pos, agent_dir, target=None, instr=None) -> EnvState:
    """A fresh state: nothing carried, step 0, ``target`` [N, 8] and
    ``instr`` [N, 4, 12] or zeros, the verifier's latches cleared."""
    n, device = grid.shape[0], grid.device
    if target is None:
        target = torch.zeros((n, 8), dtype=torch.int32, device=device)
    if instr is None:
        instr = torch.zeros((n, 4, 12), dtype=torch.int32, device=device)
    return EnvState(grid, agent_pos.long(), agent_dir.long(),
                    torch.zeros((n, 3), dtype=torch.int8, device=device),
                    torch.zeros(n, dtype=torch.int32, device=device), target.to(torch.int32),
                    instr.to(torch.int32), torch.zeros((n, 4, 2), dtype=torch.int32, device=device))


def _target(n: int, device, *columns) -> torch.Tensor:
    """[N, 8] int32 mission target: ``columns`` ([N] each) first, zeros after."""
    target = torch.zeros((n, 8), dtype=torch.int32, device=device)
    for i, c in enumerate(columns):
        target[:, i] = c
    return target


def _fixed_start(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Agent at (1, 1) facing right."""
    return (torch.ones((n, 2), dtype=torch.int64, device=device),
            torch.zeros(n, dtype=torch.int64, device=device))


def _reset_empty(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    grid = _base_grid(params, n, device)
    if params.random_start:
        pos = _sample_free_cell(grid[..., 0] == EMPTY, gen)
        return _state(grid, pos, _randint(0, 4, n, gen, device))
    return _state(grid, *_fixed_start(n, device))


def _reset_doorkey(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    w, h = params.width, params.height
    grid = _base_grid(params, n, device)
    xs, ys = _coords(w, h, device)

    # Splitting wall column: rand in [2, width-3].
    split = _randint(2, w - 2, n, gen, device).reshape(n, 1, 1)
    grid = torch.where((xs == split)[..., None], _cell(WALL, GREY, 0, device), grid)

    # Agent: uniform over empty cells strictly left of the wall.
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & (xs < split), gen)
    agent_dir = _randint(0, 4, n, gen, device)

    # Locked yellow door in the wall; row sampled in [1, width-3]
    # (MiniGrid's DoorKey uses `width` here — replicated for parity).
    door_y = _randint(1, w - 2, n, gen, device)
    env = torch.arange(n, device=device)
    grid[env, split.reshape(n), door_y] = _cell(DOOR, YELLOW, LOCKED, device)

    # Yellow key: empty cell left of the wall, not the agent's cell.
    key_pos = _sample_free_cell(
        (grid[..., 0] == EMPTY) & (xs < split) & ~_at(xs, ys, agent_pos), gen)
    grid[env, key_pos[:, 0], key_pos[:, 1]] = _cell(KEY, YELLOW, 0, device)
    return _state(grid, agent_pos, agent_dir)


def _reset_fourrooms(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """FourRooms: central cross walls with one gap per half-segment,
    random goal cell, random agent position/direction."""
    w, h = params.width, params.height
    mx, my = w // 2, h // 2
    grid = _base_grid(params, n, device, goal=False)
    xs, ys = _coords(w, h, device)
    grid = torch.where(((xs == mx) | (ys == my))[..., None], _cell(WALL, GREY, 0, device), grid)
    # One gap per half of each central wall.
    env = torch.arange(n, device=device)
    empty = _cell(EMPTY, 0, 0, device)
    grid[env, mx, _randint(1, my, n, gen, device)] = empty
    grid[env, mx, _randint(my + 1, h - 1, n, gen, device)] = empty
    grid[env, _randint(1, mx, n, gen, device), my] = empty
    grid[env, _randint(mx + 1, w - 1, n, gen, device), my] = empty

    free = grid[..., 0] == EMPTY
    goal_pos = _sample_free_cell(free, gen)
    grid[env, goal_pos[:, 0], goal_pos[:, 1]] = _cell(GOAL, GREEN, 0, device)
    agent_pos = _sample_free_cell(free & ~_at(xs, ys, goal_pos), gen)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device))


def _reset_lavagap(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """LavaGap: vertical lava strip spanning rows 1..h-2 at a random
    column x ∈ [2, w-3], with one empty gap at a random row y ∈ [1, h-2];
    agent fixed at (1,1) facing right, goal at (w-2, h-2) (upstream
    minigrid `lavagap.py:_gen_grid`)."""
    w, h = params.width, params.height
    grid = _base_grid(params, n, device)
    xs, ys = _coords(w, h, device)
    gap_x = _randint(2, w - 2, n, gen, device)
    gap_y = _randint(1, h - 1, n, gen, device)
    lava_col = (xs == gap_x.reshape(n, 1, 1)) & (ys >= 1) & (ys <= h - 2)
    grid = torch.where(lava_col[..., None], _cell(LAVA, RED, 0, device), grid)
    grid[torch.arange(n, device=device), gap_x, gap_y] = _cell(EMPTY, 0, 0, device)
    return _state(grid, *_fixed_start(n, device))


def _reset_distshift(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """DistShiftEnv: deterministic 9×7 layout — goal at (width-2, 1), a
    3-cell lava strip at x ∈ [3, width-4] in ``strip_row``, agent (1, 1)
    facing right (upstream minigrid/envs/distshift.py _gen_grid)."""
    del gen
    w, h = params.width, params.height
    grid = np.zeros((w, h, 3), dtype=np.int8)
    grid[..., 0] = EMPTY
    grid[0, :, :] = grid[w - 1, :, :] = [WALL, GREY, 0]
    grid[:, 0, :] = grid[:, h - 1, :] = [WALL, GREY, 0]
    grid[w - 2, 1, :] = [GOAL, GREEN, 0]
    grid[3:w - 3, params.strip_row, :] = [LAVA, RED, 0]
    grid = torch.as_tensor(grid, device=device).expand(n, w, h, 3).clone()
    return _state(grid, *_fixed_start(n, device))


def _reset_redblue(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """RedBlueDoorEnv: a size×size room centered in a 2size×size grid
    (walls at x = size//2 and x = size//2 + size - 1), a CLOSED red door
    at a random y on the left room wall, a closed blue door on the right
    room wall, agent on a random free room cell with a random direction
    (upstream redbluedoors.py _gen_grid)."""
    size = params.height
    lx, rx = size // 2, size // 2 + size - 1
    grid = _base_grid(params, n, device, goal=False)
    xs, ys = _coords(params.width, params.height, device)
    grid = torch.where(((xs == lx) | (xs == rx))[..., None], _cell(WALL, GREY, 0, device), grid)
    env = torch.arange(n, device=device)
    grid[env, lx, _randint(1, size - 1, n, gen, device)] = _cell(DOOR, RED, CLOSED, device)
    grid[env, rx, _randint(1, size - 1, n, gen, device)] = _cell(DOOR, BLUE, CLOSED, device)
    room = (xs > lx) & (xs < rx) & (ys >= 1) & (ys <= size - 2)
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & room, gen)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device))


def _reset_lockedroom(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """LockedRoomEnv (size 19): vertical hallway walls at width//2 ± 2,
    three room rows per side split at y = n·(height−1)//3, one door per
    room at (wall, row+3); a uniformly chosen room is LOCKED and holds
    the goal, the matching-color key sits in a different room, door
    colors are a uniform permutation; the agent starts on a free hallway
    cell (upstream minigrid/envs/lockedroom.py _gen_grid —
    reconstructed)."""
    w, h = params.width, params.height
    lwall, rwall = w // 2 - 2, w // 2 + 2
    grid = np.zeros((w, h, 3), dtype=np.int8)
    grid[..., 0] = EMPTY
    grid[0, :, :] = grid[w - 1, :, :] = [WALL, GREY, 0]
    grid[:, 0, :] = grid[:, h - 1, :] = [WALL, GREY, 0]
    grid[lwall, :, :] = grid[rwall, :, :] = [WALL, GREY, 0]
    rooms = []  # (top_x, top_y, door_x, door_y) in upstream's order
    for i in range(3):
        j = i * (h - 1) // 3
        grid[:lwall, j, :] = [WALL, GREY, 0]
        grid[rwall:, j, :] = [WALL, GREY, 0]
        rooms.append((0, j, lwall, j + 3))
        rooms.append((rwall, j, rwall, j + 3))
    grid = torch.as_tensor(grid, device=device).expand(n, w, h, 3).clone()
    rooms = torch.as_tensor(rooms, device=device)
    room_w, room_h = lwall + 1, h // 3 + 1
    env = torch.arange(n, device=device)

    def rand_pos(room_idx):
        # upstream LockedRoom.rand_pos: uniform over the room interior
        return (rooms[room_idx, 0] + _randint(1, room_w - 1, n, gen, device),
                rooms[room_idx, 1] + _randint(1, room_h - 1, n, gen, device))

    locked = _randint(0, 6, n, gen, device)
    gx, gy = rand_pos(locked)
    grid[env, gx, gy] = _cell(GOAL, GREEN, 0, device)
    # Door colors: sequential draws without replacement == a permutation.
    colors = torch.argsort(torch.rand((n, 6), generator=gen, device=device), dim=1)
    for i in range(6):
        state = torch.where(locked == i, LOCKED, CLOSED)
        grid[env, rooms[i, 2], rooms[i, 3]] = _cell(DOOR, colors[:, i], state, device)
    # Key of the locked door's color in a uniformly chosen OTHER room.
    k0 = _randint(0, 5, n, gen, device)
    kx, ky = rand_pos(k0 + (k0 >= locked).long())
    grid[env, kx, ky] = _cell(KEY, colors[env, locked], 0, device)
    # Agent on a free hallway cell.
    xs, _ = _coords(w, h, device)
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & (xs >= lwall) & (xs < rwall), gen)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device))


def _reset_crossing(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """{Simple,Lava}CrossingS{s}N{n}: ``n`` wall/lava rivers on even rows/
    columns with one opening each along a sampled room-to-room path
    (upstream minigrid crossing.py: candidate rivers at every even
    row/column in [2, size-3], shuffled, first ``n`` kept; openings placed
    by walking a shuffled h/v move sequence through the room lattice)."""
    w, h = params.width, params.height
    k = params.num_crossings
    grid = _base_grid(params, n, device)
    xs, ys = _coords(w, h, device)
    env = torch.arange(n, device=device)
    cand = torch.arange(2, h - 2, 2, device=device)
    cv = cand.numel()
    if k > 2 * cv:
        raise ValueError(f"num_crossings={k} too large for size {w}")

    # Shuffle the 2·cv candidates (ids < cv vertical, else horizontal) and
    # keep the first k; ascending candidate order == upstream's sort.
    perm = torch.argsort(torch.rand((n, 2 * cv), generator=gen, device=device), dim=1)
    sel = torch.zeros((n, 2 * cv), dtype=torch.bool, device=device)
    sel.scatter_(1, perm[:, :k], True)
    v_mask, h_mask = sel[:, :cv], sel[:, cv:]
    nv = v_mask.sum(1)
    col_river = torch.zeros((n, w), dtype=torch.bool, device=device)
    col_river[:, cand] = v_mask
    row_river = torch.zeros((n, h), dtype=torch.bool, device=device)
    row_river[:, cand] = h_mask
    vert = col_river[:, :, None] & (ys >= 1) & (ys <= h - 2)
    horz = row_river[:, None, :] & (xs >= 1) & (xs <= w - 2)
    obstacle = _cell(params.obstacle, GREY if params.obstacle == WALL else RED, 0, device)
    grid = torch.where((vert | horz)[..., None], obstacle, grid)

    # Room-lattice limits: [0, sorted selected rivers..., size-1].
    big = 10 ** 6
    limits_v = torch.zeros((n, cv + 2), dtype=torch.int64, device=device)
    limits_v[:, 1:cv + 1] = torch.sort(torch.where(v_mask, cand, big), dim=1).values
    limits_v[env, nv + 1] = h - 1
    limits_h = torch.zeros((n, cv + 2), dtype=torch.int64, device=device)
    limits_h[:, 1:cv + 1] = torch.sort(torch.where(h_mask, cand, big), dim=1).values
    limits_h[env, k - nv + 1] = w - 1

    # Path: nv horizontal moves (each crossing a vertical river) + the
    # rest vertical, shuffled; one opening per move.
    path_h = torch.argsort(torch.rand((n, k), generator=gen, device=device), dim=1) < nv[:, None]
    room_i = torch.zeros(n, dtype=torch.int64, device=device)
    room_j = torch.zeros(n, dtype=torch.int64, device=device)
    for t in range(k):
        is_h = path_h[:, t]
        u = torch.rand(n, generator=gen, device=device)
        lo_h, hi_h = limits_h[env, room_j] + 1, limits_h[env, room_j + 1]
        lo_v, hi_v = limits_v[env, room_i] + 1, limits_v[env, room_i + 1]
        j_h = lo_h + torch.minimum((u * (hi_h - lo_h).clamp_min(1)).long(),
                                   (hi_h - lo_h).clamp_min(1) - 1)
        i_v = lo_v + torch.minimum((u * (hi_v - lo_v).clamp_min(1)).long(),
                                   (hi_v - lo_v).clamp_min(1) - 1)
        oi = torch.where(is_h, limits_v[env, room_i + 1], i_v)
        oj = torch.where(is_h, j_h, limits_h[env, room_j + 1])
        grid[env, oi, oj] = _cell(EMPTY, 0, 0, device)
        room_i = room_i + is_h.long()
        room_j = room_j + (~is_h).long()
    return _state(grid, *_fixed_start(n, device))


def _reset_dynobs(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """DynamicObstaclesEnv: empty room with the goal bottom-right, agent
    at (1,1) facing right (Random variants: uniform pos/dir), and
    ``n_obstacles`` blue balls on distinct free cells (upstream
    dynamicobstacles.py _gen_grid; sequential place_obj → uniform over
    remaining free cells, agent cell excluded)."""
    grid = _base_grid(params, n, device)
    if params.random_start:
        pos = _sample_free_cell(grid[..., 0] == EMPTY, gen)
        agent_dir = _randint(0, 4, n, gen, device)
    else:
        pos, agent_dir = _fixed_start(n, device)
    xs, ys = _coords(params.width, params.height, device)
    not_agent = ~_at(xs, ys, pos)
    env = torch.arange(n, device=device)
    for _ in range(params.n_obstacles):
        bp = _sample_free_cell((grid[..., 0] == EMPTY) & not_agent, gen)
        grid[env, bp[:, 0], bp[:, 1]] = _cell(BALL, BLUE, 0, device)
    return _state(grid, pos, agent_dir)


def _reset_unlock(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """UnlockEnv: RoomGrid(room_size=6, 1×2 rooms) → an 11×6 grid split by
    a wall at x=5 with one LOCKED random-color door (y ∈ [1, 4]); a key of
    the door's color and the agent (random dir) placed on random free
    cells of the left room. No goal square — success is toggling the door
    open (upstream minigrid/envs/unlock.py). UnlockPickup (``pickup_box``)
    adds a random-color box in the right room; ObstructedMaze-1Dl
    (``pickup_ball``) the target blue ball there; ``blocked_door`` drops a
    ball directly left of the locked door (never of the target's color);
    ``key_in_box`` hides the key in a random-color box, its state channel
    1 + the key's color. BabyAI's UnlockPickupDist (``babyai_pickup``)
    names the box in ``target`` = [BOX, color, 0…] and adds ``num_objs``
    distractors, each in a random one of the two rooms, distinct from each
    other and from the key and the box (the JAX package's
    ``_reset_unlock``, :1515-1542)."""
    w, h = params.width, params.height
    grid = _base_grid(params, n, device, goal=False)
    xs, ys = _coords(w, h, device)
    grid = torch.where((xs == 5)[..., None], _cell(WALL, GREY, 0, device), grid)
    env = torch.arange(n, device=device)
    door_y = _randint(1, h - 1, n, gen, device)
    color = _randint(0, 6, n, gen, device)
    grid[env, 5, door_y] = _cell(DOOR, color, LOCKED, device)
    left_room = (xs >= 1) & (xs <= 4) & (ys >= 1) & (ys <= 4)
    right_room = (xs >= 6) & (xs <= 9) & (ys >= 1) & (ys <= 4)

    box_color = torch.zeros(n, dtype=torch.int64, device=device)
    if params.success in ("pickup_box", "babyai_pickup"):
        pos = _sample_free_cell((grid[..., 0] == EMPTY) & right_room, gen)
        box_color = _randint(0, 6, n, gen, device)
        grid[env, pos[:, 0], pos[:, 1]] = _cell(BOX, box_color, 0, device)
    if params.success == "pickup_ball":
        pos = _sample_free_cell((grid[..., 0] == EMPTY) & right_room, gen)
        grid[env, pos[:, 0], pos[:, 1]] = _cell(BALL, BLUE, 0, device)
    if params.blocked_door:
        if params.target_color >= 0:
            c0 = _randint(0, 5, n, gen, device)
            ball_color = c0 + (c0 >= params.target_color).long()
        else:
            ball_color = _randint(0, 6, n, gen, device)
        grid[env, 4, door_y] = _cell(BALL, ball_color, 0, device)

    key_pos = _sample_free_cell((grid[..., 0] == EMPTY) & left_room, gen)
    if params.key_in_box:
        key_cell = _cell(BOX, _randint(0, 6, n, gen, device), color + 1, device)
    else:
        key_cell = _cell(KEY, color, 0, device)
    grid[env, key_pos[:, 0], key_pos[:, 1]] = key_cell
    target = None
    if params.num_objs:
        # distinct from each other, the key (row 0 of the 3×6 table) and the box (row 2)
        types, colors = _distinct_objects(n, params.num_objs, gen, device,
                                          skip=(color, 12 + box_color))
        sides = _randint(0, 2, (n, params.num_objs), gen, device)
        free = grid[..., 0] == EMPTY
        for i in range(params.num_objs):
            room = torch.where((sides[:, i] == 0).reshape(n, 1, 1), left_room, right_room)
            _put(grid, free, room, _cell(types[:, i], colors[:, i], 0, device), gen)
    if params.success == "babyai_pickup":
        target = _target(n, device, BOX, box_color)
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & left_room, gen)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device), target)


def _minimax_reach(wh: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """The least time at which every room of a cols×rows room graph is
    reachable from room (0, 0): ``wh`` [N, cols-1, rows] and ``wv``
    [N, cols, rows-1] give the time each connection opens (−1 open from
    the start, inf never). A room's time is the minimax path weight from
    room (0, 0), relaxed cols·rows times (the graph-diameter bound);
    returns [N] (inf where some room is never reachable)."""
    n, cols, rows = wv.shape[0], wv.shape[1], wh.shape[2]
    d = torch.full((n, cols, rows), float("inf"), device=wh.device)
    d[:, 0, 0] = -1.0
    for _ in range(cols * rows):
        nd = d.clone()
        nd[:, 1:, :] = torch.minimum(nd[:, 1:, :], torch.maximum(d[:, :-1, :], wh))
        nd[:, :-1, :] = torch.minimum(nd[:, :-1, :], torch.maximum(d[:, 1:, :], wh))
        nd[:, :, 1:] = torch.minimum(nd[:, :, 1:], torch.maximum(d[:, :, :-1], wv))
        nd[:, :, :-1] = torch.minimum(nd[:, :, :-1], torch.maximum(d[:, :, 1:], wv))
        d = nd
    return d.amax(dim=(1, 2))


def _reset_keycorridor(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """KeyCorridorEnv: RoomGrid(room_size=S, 3 columns × R rows). The
    middle column's horizontal separators are removed (a corridor), a
    LOCKED random-color door on the left wall of a random right-column
    room hides a random-color ball, the matching key lies in a random
    left-column room, the agent starts in the middle room (row R//2,
    random cell/dir), and doors are added at random walls until every
    room is reachable from room (0, 0) — upstream keycorridor.py
    _gen_grid + roomgrid.py connect_all. The JAX package's bounded connect
    loop (``n < 256``) runs here on all 256 proposals at once: a proposal
    is applied when its wall is in range, touches no wall of the locked
    room, is not open yet and was not proposed before, and comes no later
    than the first proposal after which every room is reachable."""
    s, r = params.max_room_size, params.min_rooms
    grid = _lattice(params, s - 1, n, device)
    for j in range(1, r):  # remove_wall(1, j, 3): open the corridor
        grid[:, s:2 * (s - 1), j * (s - 1)] = _cell(EMPTY, 0, 0, device)
    env = torch.arange(n, device=device)

    def room_interior(i, j):
        return _room_interior(params, s - 1, i, j, device)

    # Locked door + ball room (right column, random row).
    room_idx = _randint(0, r, n, gen, device)
    door_color = _randint(0, 6, n, gen, device)
    door_y = room_idx * (s - 1) + _randint(1, s - 1, n, gen, device)
    grid[env, 2 * (s - 1), door_y] = _cell(DOOR, door_color, LOCKED, device)
    ball = _sample_free_cell((grid[..., 0] == EMPTY) & room_interior(2, room_idx), gen)
    grid[env, ball[:, 0], ball[:, 1]] = _cell(BALL, _randint(0, 6, n, gen, device), 0, device)
    # Matching key in a random left-column room.
    key = _sample_free_cell(
        (grid[..., 0] == EMPTY) & room_interior(0, _randint(0, r, n, gen, device)), gen)
    grid[env, key[:, 0], key[:, 1]] = _cell(KEY, door_color, 0, device)
    # Agent in the middle room of the corridor.
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & room_interior(1, r // 2), gen)
    agent_dir = _randint(0, 4, n, gen, device)

    # connect_all(), the corridor and the locked door open from the start,
    # no door onto the locked room.
    open0 = torch.zeros((n, 2 * r + 3 * (r - 1)), dtype=torch.bool, device=device)
    for j in range(r - 1):
        _open_edge(open0, 3, r, 1, j, 1)
    _open_edge(open0, 3, r, 2, room_idx, 2)
    grid = _connect_all(grid, s - 1, 3, r, open0, gen, forbid=(torch.full_like(room_idx, 2),
                                                              room_idx))
    return _state(grid, agent_pos, agent_dir)


def _multiroom_trials(params: EnvParams, n: int, gen: torch.Generator, device):
    """All 64 chain-placement trials of the MultiRoom generator at once.

    Mirrors upstream ``MultiRoomEnv._placeRoom`` as the JAX package's
    ``_multiroom_trial`` does: a greedy chain where each next room gets up
    to 8 (exit-door, size, offset) proposals, checked for bounds (the
    asymmetric ``> width`` / ``>= height`` quirk included) and overlap
    against all rooms but the immediately previous one; the first proposal
    that fits is committed. The 8 proposals of a room are evaluated
    together. Returns (count [N, T], rooms [N, T, Nmax, 4] as (topX, topY,
    sizeX, sizeY), doors [N, T, Nmax, 2])."""
    w, h = params.width, params.height
    n_max, s_max = params.max_rooms, params.max_room_size
    tr, a = MULTIROOM_TRIALS, MULTIROOM_PROPOSALS
    entry = _randint(0, w - 2, (n, tr, 2), gen, device)
    sx = _randint(4, s_max + 1, (n, tr), gen, device)
    sy = _randint(4, s_max + 1, (n, tr), gen, device)
    ok0 = (entry[..., 0] + sx <= w) & (entry[..., 1] + sy < h)
    rooms = torch.zeros((n, tr, n_max, 4), dtype=torch.int64, device=device)
    rooms[:, :, 0] = torch.stack([entry[..., 0], entry[..., 1], sx, sy], dim=-1)
    walls = torch.zeros((n, tr, n_max), dtype=torch.int64, device=device)
    walls[:, :, 0] = 2  # entryDoorWall=2
    doors = torch.zeros((n, tr, n_max, 2), dtype=torch.int64, device=device)
    doors[:, :, 0] = entry
    count = ok0.long()
    for i in range(1, n_max):
        ptx, pty, psx, psy = (rooms[:, :, i - 1, k, None] for k in range(4))
        # exit wall: uniform over sorted({0,1,2,3} - {entry wall}).
        rw = _randint(0, 3, (n, tr, a), gen, device)
        exit_wall = rw + (rw >= walls[:, :, i - 1, None]).long()
        next_wall = (exit_wall + 2) % 4
        # exit door on the chosen wall of the previous room.
        dx = ptx + _rand_between(torch.ones_like(rw), (psx - 1).expand_as(rw), gen)
        dy = pty + _rand_between(torch.ones_like(rw), (psy - 1).expand_as(rw), gen)
        ex = torch.where(exit_wall == 0, ptx + psx - 1, torch.where(exit_wall == 2, ptx, dx))
        ey = torch.where(exit_wall == 1, pty + psy - 1, torch.where(exit_wall == 3, pty, dy))
        # next room size + top-left per its entry wall (upstream ranges:
        # _rand_int(c - size + 2, c) → [c-size+2, c-1]).
        nsx = _randint(4, s_max + 1, (n, tr, a), gen, device)
        nsy = _randint(4, s_max + 1, (n, tr, a), gen, device)
        rand_tx = _rand_between(ex - nsx + 2, ex, gen)
        rand_ty = _rand_between(ey - nsy + 2, ey, gen)
        ntx = torch.where(next_wall == 0, ex - nsx + 1, torch.where(next_wall == 2, ex, rand_tx))
        nty = torch.where(next_wall == 1, ey - nsy + 1, torch.where(next_wall == 3, ey, rand_ty))
        ok = (ntx >= 0) & (nty >= 0) & (ntx + nsx <= w) & (nty + nsy < h)
        if i > 1:
            # overlap vs all rooms but the previous (asymmetric < / <= kept).
            o = rooms[:, :, None, :i - 1]  # [N, T, 1, i-1, 4]
            otx, oty, osx, osy = o[..., 0], o[..., 1], o[..., 2], o[..., 3]
            c = lambda v: v[..., None]  # noqa: E731
            non_overlap = ((c(ntx) + c(nsx) < otx) | (otx + osx <= c(ntx))
                           | (c(nty) + c(nsy) < oty) | (oty + osy <= c(nty)))
            ok = ok & non_overlap.all(-1)
        pick = ok.to(torch.uint8).argmax(-1, keepdim=True)  # the first that fits
        commit = ok.any(-1) & (count == i)
        take = lambda v: v.gather(-1, pick)[..., 0]  # noqa: E731
        new_room = torch.stack([take(ntx), take(nty), take(nsx), take(nsy)], dim=-1)
        rooms[:, :, i] = torch.where(commit[..., None], new_room, rooms[:, :, i])
        walls[:, :, i] = torch.where(commit, take(next_wall), walls[:, :, i])
        doors[:, :, i] = torch.where(commit[..., None],
                                     torch.stack([take(ex), take(ey)], dim=-1), doors[:, :, i])
        count = torch.where(commit, i + 1, count)
    return count, rooms, doors


def _reset_multiroom(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """MultiRoom-N{n}[-S{s}]: a chain of connected rooms with colored doors
    (upstream minigrid multiroom.py; 25×25 grid, no outer border — the
    rooms' own walls enclose the agent). The JAX package's keep-best loop
    (at most 64 trials, stopping at the first with every room) keeps the
    first trial with the most rooms; the 64 trials run here together and
    the same one is kept."""
    w, h = params.width, params.height
    n_max = params.max_rooms
    counts, all_rooms, all_doors = _multiroom_trials(params, n, gen, device)
    env = torch.arange(n, device=device)
    best = counts.argmax(dim=1)  # the first trial of the largest count
    count, rooms, doors = counts[env, best], all_rooms[env, best], all_doors[env, best]

    # Render: empty grid (no border), room wall rectangles in placement
    # order, each room's entry door set right after its walls.
    grid = torch.zeros((n, w, h, 3), dtype=torch.int8, device=device)
    grid[..., 0] = EMPTY
    xs, ys = _coords(w, h, device)
    wall = _cell(WALL, GREY, 0, device)

    def inside(room):
        tx, ty, sx, sy = (room[:, k].reshape(n, 1, 1) for k in range(4))
        return (xs >= tx) & (xs < tx + sx) & (ys >= ty) & (ys < ty + sy), (tx, ty, sx, sy)

    prev_color = None
    for i in range(n_max):
        ins, (tx, ty, sx, sy) = inside(rooms[:, i])
        border = ins & ((xs == tx) | (xs == tx + sx - 1) | (ys == ty) | (ys == ty + sy - 1))
        valid = count > i
        grid = torch.where((border & valid.reshape(n, 1, 1))[..., None], wall, grid)
        if i > 0:
            # door color ≠ previous door's color (uniform over the rest).
            if prev_color is None:
                color = _randint(0, 6, n, gen, device)
            else:
                color = _randint(0, 5, n, gen, device)
                color = color + (color >= prev_color).long()
            dx, dy = doors[:, i, 0], doors[:, i, 1]
            grid[env, dx, dy] = torch.where(valid[:, None], _cell(DOOR, color, CLOSED, device),
                                            grid[env, dx, dy])
            prev_color = color

    # Agent: uniform over empty cells of the first room; goal: uniform over
    # empty cells of the last room, not the agent's cell.
    empty = grid[..., 0] == EMPTY
    agent_pos = _sample_free_cell(inside(rooms[:, 0])[0] & empty, gen)
    agent_dir = _randint(0, 4, n, gen, device)
    last = rooms[env, (count - 1).clamp_min(0)]
    goal = _sample_free_cell(inside(last)[0] & empty & ~_at(xs, ys, agent_pos), gen)
    grid[env, goal[:, 0], goal[:, 1]] = _cell(GOAL, GREEN, 0, device)
    return _state(grid, agent_pos, agent_dir)


def _reset_obstructedfull(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """ObstructedMaze 2Dl*/1Q/2Q/Full: a 3×3 RoomGrid of 6×6 rooms (16×16
    grid, walls at multiples of 5). Door colors are a permutation of the
    six; for each of the first ``min_rooms`` quarters ``i`` the middle room
    (1, 1) gets a CLOSED door on wall ``i`` (color ``i``) onto side room
    ``SIDE[i]``, and the side room gets LOCKED doors on walls (i±1) % 4
    with colors (i±1) % 6, each optionally blocked by a ball, never blue
    (``c0 + (c0 ≥ BLUE)``), on the side-room cell before it. All doors and
    blockers are placed before any key; the keys (optionally in a box whose
    state is color + 1) go on free cells of the side room. The target BLUE
    ball sits in one of the first ``min_rooms`` corners; the agent starts
    in ``agent_room`` (the JAX package's ``_reset_obstructedfull``)."""
    side = ((2, 1), (1, 2), (0, 1), (1, 0))
    corner = ((2, 0), (2, 2), (0, 2), (0, 0))
    grid = _lattice(params, 5, n, device)
    env = torch.arange(n, device=device)

    def room_interior(i, j):
        return _room_interior(params, 5, i, j, device)

    def door_pos(i, j, d):
        # wall ``d`` (DIR_TO_VEC order) of room (i, j) at an offset in [1, 4]
        off = _randint(1, 5, n, gen, device)
        if d == 0:
            return torch.full_like(off, (i + 1) * 5), j * 5 + off
        if d == 1:
            return i * 5 + off, torch.full_like(off, (j + 1) * 5)
        if d == 2:
            return torch.full_like(off, i * 5), j * 5 + off
        return i * 5 + off, torch.full_like(off, j * 5)

    colors = torch.argsort(torch.rand((n, 6), generator=gen, device=device), dim=1)
    for i in range(params.min_rooms):
        si, sj = side[i]
        x, y = door_pos(1, 1, i)
        grid[env, x, y] = _cell(DOOR, colors[:, i], CLOSED, device)
        for k in (-1, 1):
            d = (i + k) % 4
            x, y = door_pos(si, sj, d)
            grid[env, x, y] = _cell(DOOR, colors[:, (i + k) % 6], LOCKED, device)
            if params.blocked_door:
                c0 = _randint(0, 5, n, gen, device)
                grid[env, x - int(DIR_TO_VEC[d][0]), y - int(DIR_TO_VEC[d][1])] = _cell(
                    BALL, c0 + (c0 >= BLUE).long(), 0, device)
        for k in (-1, 1):
            color = colors[:, (i + k) % 6]
            kpos = _sample_free_cell((grid[..., 0] == EMPTY) & room_interior(si, sj), gen)
            if params.key_in_box:
                cell = _cell(BOX, _randint(0, 6, n, gen, device), color + 1, device)
            else:
                cell = _cell(KEY, color, 0, device)
            grid[env, kpos[:, 0], kpos[:, 1]] = cell
    ball_room = _randint(0, params.min_rooms, n, gen, device)
    corners = torch.cat([room_interior(*corner[t]) for t in range(params.min_rooms)])
    ball = _sample_free_cell(corners[ball_room] & (grid[..., 0] == EMPTY), gen)
    grid[env, ball[:, 0], ball[:, 1]] = _cell(BALL, BLUE, 0, device)
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & room_interior(*params.agent_room), gen)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device))


def _reset_playground(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """PlaygroundEnv: 19×19, 3×3 rooms of 6×6 (walls at x, y ∈ {6, 12}),
    one CLOSED random-color door per internal wall segment (12 doors, at
    offsets 1–5 of their segment), the agent on any free cell first, then
    12 random key/ball/box objects of random colors on free cells other
    than the agent's. No goal, no reward (the JAX package's
    ``_reset_playground``)."""
    w, h = params.width, params.height
    grid = _lattice(params, 6, n, device)
    env = torch.arange(n, device=device)
    for i in range(2):
        for j in range(3):
            off, color = _randint(1, 6, n, gen, device), _randint(0, 6, n, gen, device)
            grid[env, (i + 1) * 6, j * 6 + off] = _cell(DOOR, color, CLOSED, device)
            off, color = _randint(1, 6, n, gen, device), _randint(0, 6, n, gen, device)
            grid[env, j * 6 + off, (i + 1) * 6] = _cell(DOOR, color, CLOSED, device)
    xs, ys = _coords(w, h, device)
    agent_pos = _sample_free_cell(grid[..., 0] == EMPTY, gen)
    not_agent = ~_at(xs, ys, agent_pos)
    types = torch.tensor([KEY, BALL, BOX], device=device)
    for _ in range(12):
        obj = types[_randint(0, 3, n, gen, device)]
        color = _randint(0, 6, n, gen, device)
        pos = _sample_free_cell((grid[..., 0] == EMPTY) & not_agent, gen)
        grid[env, pos[:, 0], pos[:, 1]] = _cell(obj, color, 0, device)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device))


def _reset_memory(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """MemoryEnv: a start room holding one green key-or-ball, a hallway to a
    T-fork with a green ball and a green key on the far side of the
    vertical wall at ``hallway_end`` (``w − 3``, or drawn in [4, w − 3] per
    episode for the Random ids); the agent starts at a random x in
    [1, hallway_end] of the middle row, facing right. The cell in front of
    the object matching the start room's is the success cell, the other
    side's the failure cell: ``target`` = [sx, sy, fx, fy, 0…] (the JAX
    package's ``_reset_memory``)."""
    w, h = params.width, params.height
    mid = h // 2
    upper, lower = mid - 2, mid + 2
    if params.random_length:
        hallway_end = _randint(4, w - 2, n, gen, device)
    else:
        hallway_end = torch.full((n,), w - 3, dtype=torch.int64, device=device)
    he = hallway_end.reshape(n, 1, 1)
    xs, ys = _coords(w, h, device)
    border = (xs == 0) | (xs == w - 1) | (ys == 0) | (ys == h - 1)
    start_room = ((ys == upper) | (ys == lower)) & (xs >= 1) & (xs <= 4)
    start_corner = (xs == 4) & ((ys == upper + 1) | (ys == lower - 1))
    hallway = ((ys == upper + 1) | (ys == lower - 1)) & (xs >= 5) & (xs < he)
    vertical = (xs == he) & (ys != mid)
    wall = border | start_room | start_corner | hallway | vertical
    grid = torch.where(wall[..., None], _cell(WALL, GREY, 0, device), _cell(EMPTY, 0, 0, device))
    env = torch.arange(n, device=device)
    start_obj = torch.where(_randint(0, 2, n, gen, device) == 0, KEY, BALL)
    grid[env, 1, mid - 1] = _cell(start_obj, GREEN, 0, device)
    top_is_ball = _randint(0, 2, n, gen, device) == 0
    top_obj = torch.where(top_is_ball, BALL, KEY)
    bot_obj = torch.where(top_is_ball, KEY, BALL)
    grid[env, hallway_end + 1, mid - 2] = _cell(top_obj, GREEN, 0, device)
    grid[env, hallway_end + 1, mid + 2] = _cell(bot_obj, GREEN, 0, device)
    top_matches = top_obj == start_obj
    sx = hallway_end + 1
    sy = torch.where(top_matches, mid - 1, mid + 1)
    fy = torch.where(top_matches, mid + 1, mid - 1)
    agent_x = _rand_between(torch.ones_like(hallway_end), hallway_end + 1, gen)
    agent_pos = torch.stack([agent_x, torch.full_like(agent_x, mid)], dim=-1)
    return _state(grid, agent_pos, torch.zeros(n, dtype=torch.int64, device=device),
                  _target(n, device, sx, sy, sx, fy))


def _reset_gotodoor(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """GoToDoorEnv: the room's width and height are drawn per episode in
    [5, size], and cells outside the room stay EMPTY; four CLOSED doors
    (top, bottom, left, right, at offsets in [2, r − 3]) take the first 4
    colors of a permutation; the agent starts on a free room cell; the
    mission targets one door uniformly: ``target`` = [DOOR, color, x, y,
    0…] (the JAX package's ``_reset_gotodoor``)."""
    w, h = params.width, params.height
    rw = _randint(5, w + 1, n, gen, device)
    rh = _randint(5, h + 1, n, gen, device)
    rwb, rhb = rw.reshape(n, 1, 1), rh.reshape(n, 1, 1)
    xs, ys = _coords(w, h, device)
    wall = ((((xs == 0) | (xs == rwb - 1)) & (ys < rhb))
            | (((ys == 0) | (ys == rhb - 1)) & (xs < rwb)))
    grid = torch.where(wall[..., None], _cell(WALL, GREY, 0, device), _cell(EMPTY, 0, 0, device))
    two, zero = torch.full_like(rw, 2), torch.zeros_like(rw)
    door_x = torch.stack([_rand_between(two, rw - 2, gen), _rand_between(two, rw - 2, gen),
                          zero, rw - 1], dim=1)
    door_y = torch.stack([zero, rh - 1, _rand_between(two, rh - 2, gen),
                          _rand_between(two, rh - 2, gen)], dim=1)
    colors = torch.argsort(torch.rand((n, 6), generator=gen, device=device), dim=1)[:, :4]
    env = torch.arange(n, device=device)
    for i in range(4):
        grid[env, door_x[:, i], door_y[:, i]] = _cell(DOOR, colors[:, i], CLOSED, device)
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & (xs < rwb) & (ys < rhb), gen)
    agent_dir = _randint(0, 4, n, gen, device)
    t = _randint(0, 4, n, gen, device)
    return _state(grid, agent_pos, agent_dir,
                  _target(n, device, DOOR, colors[env, t], door_x[env, t], door_y[env, t]))


def _place_objects(grid: torch.Tensor, types: torch.Tensor, colors: torch.Tensor,
                   gen: torch.Generator, spread: bool = False) -> torch.Tensor:
    """Put object k of ``types``/``colors`` [N, K] on a uniform free cell of
    each env, one after another; with ``spread`` no cell within Chebyshev
    distance 1 of an earlier object is free. Returns the cells [N, K, 2]."""
    n, w, h = grid.shape[:3]
    device = grid.device
    xs, ys = _coords(w, h, device)
    env = torch.arange(n, device=device)
    near_any = torch.zeros((n, w, h), dtype=torch.bool, device=device)
    cells = []
    for k in range(types.shape[1]):
        pos = _sample_free_cell((grid[..., 0] == EMPTY) & ~near_any, gen)
        grid[env, pos[:, 0], pos[:, 1]] = _cell(types[:, k], colors[:, k], 0, device)
        if spread:
            near_any |= (((xs - pos[:, 0].reshape(n, 1, 1)).abs() <= 1)
                         & ((ys - pos[:, 1].reshape(n, 1, 1)).abs() <= 1))
        cells.append(pos)
    return torch.stack(cells, dim=1)


def _distinct_objects(n: int, k: int, gen: torch.Generator, device, skip=()):
    """``k`` distinct (type, color) pairs over {key, ball, box} × 6 colors
    per env: a uniform k-prefix of a permutation of the 18 pairs, the
    distribution of upstream's draw-and-reject, without the pairs ``skip``
    (type row · 6 + color, [N] each, in ascending order). Returns
    ([N, K], [N, K])."""
    combo = torch.argsort(torch.rand((n, 18 - len(skip)), generator=gen, device=device),
                          dim=1)[:, :k]
    for v in skip:
        combo = combo + (combo >= v[:, None]).long()
    return torch.tensor([KEY, BALL, BOX], device=device)[combo // 6], combo % 6


def _reset_fetch(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """FetchEnv: ``num_objs`` keys/balls of independently random types and
    colors (duplicate pairs allowed) on free cells, the agent on a free
    cell, and one object chosen as the mission: ``target`` = [type, color,
    0…] (the JAX package's ``_reset_fetch``)."""
    k = params.num_objs
    grid = _base_grid(params, n, device, goal=False)
    types = torch.where(_randint(0, 2, (n, k), gen, device) == 0, KEY, BALL)
    colors = _randint(0, 6, (n, k), gen, device)
    _place_objects(grid, types, colors, gen)
    agent_pos = _sample_free_cell(grid[..., 0] == EMPTY, gen)
    agent_dir = _randint(0, 4, n, gen, device)
    env, t = torch.arange(n, device=device), _randint(0, k, n, gen, device)
    return _state(grid, agent_pos, agent_dir, _target(n, device, types[env, t], colors[env, t]))


def _reset_gotoobject(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """GoToObjectEnv: ``num_objs`` DISTINCT (type, color) key/ball/box
    objects on free cells, the agent on a free cell, one object as the
    mission: ``target`` = [type, color, x, y, 0…] (the JAX package's
    ``_reset_gotoobject``)."""
    k = params.num_objs
    grid = _base_grid(params, n, device, goal=False)
    types, colors = _distinct_objects(n, k, gen, device)
    cells = _place_objects(grid, types, colors, gen)
    agent_pos = _sample_free_cell(grid[..., 0] == EMPTY, gen)
    agent_dir = _randint(0, 4, n, gen, device)
    env, t = torch.arange(n, device=device), _randint(0, k, n, gen, device)
    return _state(grid, agent_pos, agent_dir, _target(
        n, device, types[env, t], colors[env, t], cells[env, t, 0], cells[env, t, 1]))


def _reset_putnear(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """PutNearEnv: ``num_objs`` distinct (type, color) objects, no two
    within Chebyshev distance 1 of each other; the mission moves object
    ``mv`` near a DIFFERENT object ``t0 + (t0 ≥ mv)``: ``target`` =
    [move_obj, move_color, near_obj, near_color, near_x, near_y, 0, 0]
    (the JAX package's ``_reset_putnear``)."""
    k = params.num_objs
    grid = _base_grid(params, n, device, goal=False)
    types, colors = _distinct_objects(n, k, gen, device)
    cells = _place_objects(grid, types, colors, gen, spread=True)
    agent_pos = _sample_free_cell(grid[..., 0] == EMPTY, gen)
    agent_dir = _randint(0, 4, n, gen, device)
    env = torch.arange(n, device=device)
    mv = _randint(0, k, n, gen, device)
    t0 = _randint(0, k - 1, n, gen, device)
    tg = t0 + (t0 >= mv).long()
    return _state(grid, agent_pos, agent_dir, _target(
        n, device, types[env, mv], colors[env, mv], types[env, tg], colors[env, tg],
        cells[env, tg, 0], cells[env, tg, 1]))


# ---------------------------------------------------------------------------
# BabyAI: the levels whose mission ``EnvState.target`` decides
# ---------------------------------------------------------------------------

BABYAI_ATTEMPTS = 64           # the JAX package's rejection bound (`core.py:2315`)
BABYAI_UNBLOCK_ATTEMPTS = 256  # UnblockPickup's (`core.py:2646`)
REACH_CHECK_EVERY = 8          # flood-fill dilations between two convergence checks
_OBJ_TYPES = (KEY, BALL, BOX)


def _objs_reachable(grid: torch.Tensor, agent_pos: torch.Tensor) -> torch.Tensor:
    """BabyAI's ``check_objs_reachable`` for every env at once → [N] bool: a
    flood fill from the agent over EMPTY and DOOR cells (any door, locked
    included), to its fixed point, after which every cell that is neither
    EMPTY nor WALL must lie in the fill or next to it (the JAX package's
    ``_objs_reachable``, with its ``roll``: border cells are walls, so
    nothing wraps). The fill dilates all envs together and asks the host
    whether it has stopped growing once every ``REACH_CHECK_EVERY``
    dilations; a fill does not change past its fixed point."""
    w, h = grid.shape[1:3]
    obj = grid[..., 0]
    free = (obj == EMPTY) | (obj == DOOR)
    xs, ys = _coords(w, h, grid.device)
    reach = _at(xs, ys, agent_pos)

    def grow(r):
        return r | r.roll(1, 1) | r.roll(-1, 1) | r.roll(1, 2) | r.roll(-1, 2)

    for _ in range(0, w * h, REACH_CHECK_EVERY):
        before = reach
        for _ in range(REACH_CHECK_EVERY):
            reach = grow(reach) & free
        if torch.equal(before, reach):
            break
    objs = (obj != EMPTY) & (obj != WALL)
    return (grow(reach) | ~objs).flatten(1).all(1)


def _rejection(build, n: int, accept, attempts: int, what: str) -> tuple:
    """``build(m)`` → a tuple of tensors of leading size m, drawn again for
    the envs whose draw ``accept`` ([m] bool) rejects until every env's is
    accepted. Raises after ``attempts`` draws of one env, where the JAX
    package would keep its last draw: the port keeps no rejected layout."""
    out = build(n)
    ok = accept(out)
    for _ in range(attempts - 1):
        redo = (~ok).nonzero()[:, 0]
        if redo.numel() == 0:
            return out
        new = build(redo.numel())
        for t, v in zip(out, new):
            t[redo] = v
        ok[redo] = accept(new)
    if not bool(ok.all()):
        raise RuntimeError(f"{what}: {int((~ok).sum())} envs drew {attempts} rejected layouts")
    return out


def _take(free: torch.Tensor, where, gen: torch.Generator) -> torch.Tensor:
    """A uniform cell of ``free & where`` of each env (``where`` None for all
    of ``free``), which leaves ``free`` → [N, 2]."""
    pos = _sample_free_cell(free if where is None else free & where, gen)
    free[torch.arange(free.shape[0], device=free.device), pos[:, 0], pos[:, 1]] = False
    return pos


def _put(grid: torch.Tensor, free: torch.Tensor, where, cell: torch.Tensor,
         gen: torch.Generator) -> torch.Tensor:
    """Put ``cell`` [N, 3] on :func:`_take`'s cell; returns it [N, 2]."""
    pos = _take(free, where, gen)
    grid[torch.arange(grid.shape[0], device=grid.device), pos[:, 0], pos[:, 1]] = cell
    return pos


def _random_objects(n: int, k: int, gen: torch.Generator, device):
    """``k`` independent uniform key/ball/box types and colors per env →
    ([N, K], [N, K]) (duplicates allowed: add_distractors(all_unique=False))."""
    types = torch.tensor(_OBJ_TYPES, device=device)[_randint(0, 3, (n, k), gen, device)]
    return types, _randint(0, 6, (n, k), gen, device)


def _lattice(params: EnvParams, pitch: int, n: int, device) -> torch.Tensor:
    """[N, W, H, 3] RoomGrid walls: every ``pitch``-th column and row."""
    grid = np.zeros((params.width, params.height, 3), dtype=np.int8)
    grid[..., 0] = EMPTY
    grid[::pitch, :, :] = [WALL, GREY, 0]
    grid[:, ::pitch, :] = [WALL, GREY, 0]
    return torch.as_tensor(grid, device=device).expand(n, *grid.shape).clone()


def _room_interior(params: EnvParams, pitch: int, i, j, device) -> torch.Tensor:
    """[N or 1, W, H]: the interior of RoomGrid room (i, j) (ints or [N])."""
    xs, ys = _coords(params.width, params.height, device)
    i = torch.as_tensor(i, device=device).reshape(-1, 1, 1)
    j = torch.as_tensor(j, device=device).reshape(-1, 1, 1)
    return ((xs > i * pitch) & (xs < (i + 1) * pitch)
            & (ys > j * pitch) & (ys < (j + 1) * pitch))


def _babyai_room(params: EnvParams, n: int, gen: torch.Generator, device, sample_objs,
                 check_reachable: bool = True):
    """BabyAI's single bordered room (the JAX package's ``_babyai_room``):
    the agent on a uniform interior cell, then the objects ``sample_objs(m)``
    → ([m, K], [m, K]) one after another on the cells left free; with
    ``check_reachable`` a layout is kept only when every object is reachable.
    Returns (grid, agent_pos, agent_dir, types, colors)."""

    def build(m):
        types, colors = sample_objs(m)
        grid = _base_grid(params, m, device, goal=False)
        free = grid[..., 0] == EMPTY
        agent_pos = _take(free, None, gen)
        agent_dir = _randint(0, 4, m, gen, device)
        for k in range(types.shape[1]):
            _put(grid, free, None, _cell(types[:, k], colors[:, k], 0, device), gen)
        return grid, agent_pos, agent_dir, types, colors

    if not check_reachable:
        return build(n)
    return _rejection(build, n, lambda o: _objs_reachable(o[0], o[1]), BABYAI_ATTEMPTS,
                      params.kind)


def _reset_babyai_goto(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """BabyAI's GoTo room (GoToRedBall{,Grey,NoDists}, GoToRedBlueBall,
    GoToObj, GoToLocal, OneRoom): with a fixed target, object 0 is a ball —
    red (GoToRedBall), red or blue (GoToRedBlueBall, whose distractors are
    drawn over the 16 pairs that are no red or blue ball) or of any color
    (OneRoom, a type-only mission: ``target`` = [BALL, −1, 0…]) — and
    ``num_objs`` random distractors follow (grey in GoToRedBallGrey);
    otherwise the mission names a uniform one of the ``num_objs`` objects:
    ``target`` = [type, color, 0…] (the JAX package's
    ``_reset_babyai_goto``)."""
    fixed = params.target_color >= 0 or params.rb_target or params.type_only
    k = params.num_objs + int(fixed)

    def sample_objs(m):
        if params.rb_target:
            u = _randint(0, 16, (m, k), gen, device)
            pair = u + (u >= 6).long() + (u >= 7).long()  # skips the red and the blue ball
            types = torch.tensor(_OBJ_TYPES, device=device)[pair // 6]
            colors = pair % 6
            colors[:, 0] = torch.tensor([RED, BLUE], device=device)[_randint(0, 2, m, gen, device)]
        else:
            types, colors = _random_objects(m, k, gen, device)
            if params.grey_dists:
                colors = torch.full_like(colors, GREY)
            if fixed and not params.type_only:
                colors[:, 0] = RED
        if fixed:
            types[:, 0] = BALL
        return types, colors

    grid, agent_pos, agent_dir, types, colors = _babyai_room(params, n, gen, device, sample_objs)
    if fixed:
        color = torch.full((n,), -1, device=device) if params.type_only else colors[:, 0]
        target = _target(n, device, BALL, color)
    else:
        env, t = torch.arange(n, device=device), _randint(0, k, n, gen, device)
        target = _target(n, device, types[env, t], colors[env, t])
    return _state(grid, agent_pos, agent_dir, target)


def _reset_babyai_putnext(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """PutNextLocal: ``num_objs`` distinct objects in one room, reachability
    rejected; the mission puts object ``mv`` next to a different object:
    ``target`` = [move_type, move_color, fixed_type, fixed_color, 0…] (the
    JAX package's ``_reset_babyai_putnext``)."""
    k = params.num_objs
    grid, agent_pos, agent_dir, types, colors = _babyai_room(
        params, n, gen, device, lambda m: _distinct_objects(m, k, gen, device))
    env = torch.arange(n, device=device)
    mv = _randint(0, k, n, gen, device)
    t0 = _randint(0, k - 1, n, gen, device)
    tg = t0 + (t0 >= mv).long()
    return _state(grid, agent_pos, agent_dir, _target(
        n, device, types[env, mv], colors[env, mv], types[env, tg], colors[env, tg]))


def _reset_babyai_pickup(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """PickupDist: 5 distinct objects in one 7×7 room, no reachability check;
    the mission names one by its type, its color or both, uniformly:
    ``target`` = [type | −1, color | −1, 0…] (the JAX package's
    ``_reset_babyai_pickup``)."""
    k = params.num_objs
    grid, agent_pos, agent_dir, types, colors = _babyai_room(
        params, n, gen, device, lambda m: _distinct_objects(m, k, gen, device),
        check_reachable=False)
    env, t = torch.arange(n, device=device), _randint(0, k, n, gen, device)
    sel = _randint(0, 3, n, gen, device)  # 0 type, 1 color, 2 both
    return _state(grid, agent_pos, agent_dir, _target(
        n, device, torch.where(sel == 1, -1, types[env, t]),
        torch.where(sel == 0, -1, colors[env, t])))


def _reset_babyai_openred(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """OpenRedDoor: two 5×5 rooms (9×5, the shared wall at x = 4), a CLOSED
    red door at a random y of that wall, the agent in the left room;
    ``target`` = [4·height + y + 1, 0…], the door's packed position + 1 (the
    JAX package's ``_reset_babyai_openred``)."""
    w, h = params.width, params.height
    grid = _base_grid(params, n, device, goal=False)
    xs, _ = _coords(w, h, device)
    grid[:, 4] = _cell(WALL, GREY, 0, device)
    dy = _randint(1, h - 1, n, gen, device)
    grid[torch.arange(n, device=device), 4, dy] = _cell(DOOR, RED, CLOSED, device)
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & (xs < 4), gen)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device),
                  _target(n, device, 4 * h + dy + 1))


def _center_doors(grid: torch.Tensor, pitch: int, colors: torch.Tensor,
                  gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """One CLOSED door on each wall of the center room of a 3×3 RoomGrid —
    east, south, west, north (``add_door`` 0..3), at uniform offsets along
    the wall — colored ``colors`` [N, 4]. Returns (dx, dy), [N, 4] each."""
    n, device = grid.shape[0], grid.device
    offs = _randint(pitch + 1, 2 * pitch, (n, 4), gen, device)
    near = torch.full((n,), pitch, device=device)
    far = torch.full((n,), 2 * pitch, device=device)
    dx = torch.stack([far, offs[:, 1], near, offs[:, 3]], dim=1)
    dy = torch.stack([offs[:, 0], far, offs[:, 2], near], dim=1)
    env = torch.arange(n, device=device)
    for i in range(4):
        grid[env, dx[:, i], dy[:, i]] = _cell(DOOR, colors[:, i], CLOSED, device)
    return dx, dy


LOCATION_WORDS = ("left", "right", "front", "behind")


def door_sides(agent_pos: torch.Tensor, agent_dir: torch.Tensor, dx: torch.Tensor,
               dy: torch.Tensor) -> torch.Tensor:
    """[N, 4, K] bool: which of the cells (``dx``, ``dy``) [N, K] each of
    ``LOCATION_WORDS`` names from the pose (``agent_pos`` [N, 2],
    ``agent_dir`` [N]) — BabyAI's ObjDesc rule over v, the vector from the
    agent to the cell: left v·right < 0, right v·right > 0, front
    v·forward > 0, behind v·forward < 0, where right is the direction one
    turn clockwise of forward (the JAX package's ``_reset_babyai_opendoor``,
    :2805-2810)."""
    dir_vec = torch.as_tensor(DIR_TO_VEC, device=agent_pos.device)
    d1, d2 = dir_vec[agent_dir], dir_vec[(agent_dir + 1) % 4]
    vx, vy = dx - agent_pos[:, :1], dy - agent_pos[:, 1:]
    forward = vx * d1[:, :1] + vy * d1[:, 1:]
    right = vx * d2[:, :1] + vy * d2[:, 1:]
    return torch.stack([right < 0, right > 0, forward > 0, forward < 0], dim=1)


def _reset_babyai_opendoor(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """OpenDoor[Color|Loc][Debug]: a 3×3 RoomGrid of 8×8 rooms, the center
    room's four doors in 4 distinct colors, the agent inside. The mission's
    doors: the east one (by color), or every door on the side of the agent's
    start pose that a location word names (left/right: the sign of v·right,
    front/behind: of v·forward, v from the agent to the door);
    ``select_by=""`` draws the mode per episode. ``target[:4]`` holds the
    matched doors' ``x·height + y + 1``, 0 elsewhere (the JAX package's
    ``_reset_babyai_opendoor``)."""
    grid = _lattice(params, 7, n, device)
    colors = torch.argsort(torch.rand((n, 6), generator=gen, device=device), dim=1)[:, :4]
    dx, dy = _center_doors(grid, 7, colors, gen)
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & _room_interior(params, 7, 1, 1, device),
                                  gen)
    agent_dir = _randint(0, 4, n, gen, device)
    if params.select_by:
        sel = torch.full((n,), int(params.select_by == "loc"), device=device)
    else:
        sel = _randint(0, 2, n, gen, device)  # 0 color, 1 location
    loc = _randint(0, 4, n, gen, device)
    loc_ok = door_sides(agent_pos, agent_dir, dx, dy)[torch.arange(n, device=device), loc]
    match = torch.where((sel == 0)[:, None], torch.arange(4, device=device) == 0, loc_ok)
    target = torch.zeros((n, 8), dtype=torch.int32, device=device)
    target[:, :4] = torch.where(match, dx * params.height + dy + 1, 0)
    return _state(grid, agent_pos, agent_dir, target)


def _wall_door(pitch: int, i, j, d, off):
    """The cell of a door on wall ``d`` (DIR_TO_VEC order) of RoomGrid room
    (i, j) at ``off`` along the wall."""
    x = torch.where(d == 0, (i + 1) * pitch, torch.where(d == 2, i * pitch, i * pitch + off))
    y = torch.where(d == 1, (j + 1) * pitch, torch.where(d == 3, j * pitch, j * pitch + off))
    return x, y


def _edge(cols: int, rows: int, i, j, d):
    """The connection through wall ``d`` of room (i, j) of a cols×rows
    RoomGrid: h(i, j), joining (i, j) and (i+1, j), is i·rows + j; v(i, j),
    joining (i, j) and (i, j+1), is (cols−1)·rows + i·(rows−1) + j."""
    v = (cols - 1) * rows + i * (rows - 1) + j
    return torch.where(d == 0, i * rows + j,
                       torch.where(d == 2, (i - 1) * rows + j, torch.where(d == 1, v, v - 1)))


def _open_edge(open0: torch.Tensor, cols: int, rows: int, i, j, d) -> None:
    """Mark the connection through wall ``d`` of room (i, j) open in
    ``open0`` [N, E] (ints or [N] tensors)."""
    n, device = open0.shape[0], open0.device
    i, j, d = (torch.as_tensor(v, device=device).expand(n) for v in (i, j, d))
    open0[torch.arange(n, device=device), _edge(cols, rows, i, j, d)] = True


def _connect_all(grid: torch.Tensor, pitch: int, cols: int, rows: int, open0: torch.Tensor,
                 gen: torch.Generator, avoid: Optional[torch.Tensor] = None,
                 forbid=None) -> torch.Tensor:
    """RoomGrid's ``connect_all`` on a cols×rows maze of rooms ``pitch`` + 1
    wide: CLOSED random-color doors at random walls until every room
    reaches room (0, 0) (the JAX package's bounded loops of
    ``_reset_keycorridor`` and ``_reset_babyai_gotomaze``). ``open0`` [N, E]
    marks the connections open before it (:func:`_edge`'s numbering);
    ``avoid`` [N] a color the doors skip (−1 none); ``forbid`` ([N], [N]) a
    room no door may touch. The JAX loop's 256 proposals (``n < 256``) are
    drawn at once: a proposal is applied when its wall is in range, touches
    no forbidden room, is not open yet and was not proposed before, and
    comes no later than the first proposal after which every room is
    reachable (the minimax time of :func:`_minimax_reach`)."""
    n, w, h = grid.shape[:3]
    device = grid.device
    p, e = CONNECT_PROPOSALS, open0.shape[1]
    pi, pj = _randint(0, cols, (n, p), gen, device), _randint(0, rows, (n, p), gen, device)
    pd = _randint(0, 4, (n, p), gen, device)
    off = _randint(1, pitch, (n, p), gen, device)
    pcolor = _randint(0, 6, (n, p), gen, device)
    if avoid is not None:
        c5, avoid = _randint(0, 5, (n, p), gen, device), avoid[:, None]
        pcolor = torch.where(avoid >= 0, c5 + (c5 >= avoid).long(), pcolor)
    dvec = torch.as_tensor(DIR_TO_VEC, device=device)[pd]
    ni, nj = pi + dvec[..., 0], pj + dvec[..., 1]
    in_range = (ni >= 0) & (ni < cols) & (nj >= 0) & (nj < rows)
    edge = torch.where(in_range, _edge(cols, rows, pi, pj, pd), e)  # e: a sink
    open0 = torch.cat([open0, torch.zeros((n, 1), dtype=torch.bool, device=device)], dim=1)
    ok = in_range & ~open0.gather(1, edge)
    if forbid is not None:
        fi, fj = forbid[0][:, None], forbid[1][:, None]
        ok = ok & ~(((pi == fi) & (pj == fj)) | ((ni == fi) & (nj == fj)))
    t = torch.arange(p, device=device).expand(n, p)
    first = torch.full((n, e + 1), p, dtype=torch.int64, device=device)
    first.scatter_reduce_(1, torch.where(ok, edge, e), t, "amin")
    valid = ok & (first.gather(1, edge) == t)
    # Each connection's opening time: -1 from the start, its first valid
    # proposal, or never (inf).
    when = torch.where(first[:, :e] < p, first[:, :e].float(), float("inf"))
    when = torch.where(open0[:, :e], -1.0, when)
    wh = when[:, :(cols - 1) * rows].reshape(n, cols - 1, rows)
    wv = when[:, (cols - 1) * rows:].reshape(n, cols, rows - 1)
    last = _minimax_reach(wh, wv).clamp(max=p - 1)
    applied = valid & (t <= last[:, None])
    # Doors of the applied proposals (distinct walls, so distinct cells).
    x, y = _wall_door(pitch, pi, pj, pd, off)
    flat = torch.where(applied, x * h + y, w * h)
    cells = torch.cat([grid.reshape(n, w * h, 3),
                       torch.zeros((n, 1, 3), dtype=torch.int8, device=device)], dim=1)
    cells[torch.arange(n, device=device)[:, None], flat] = _cell(DOOR, pcolor, CLOSED, device)
    return cells[:, :w * h].reshape(n, w, h, 3)


def _reset_babyai_gotomaze(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """BabyAI's maze tier (GoTo[Open], GoToObjMaze*, Pickup, UnblockPickup,
    Open, Unlock, GoToImpUnlock, FindObj, PickupAbove; the JAX package's
    ``_reset_babyai_gotomaze``): a C×R RoomGrid of S×S rooms. The unlock tier
    first locks a random wall of a random room (a LOCKED random-color door;
    Unlock's doors avoid its color with probability 1/2). The agent goes in
    a uniform room (not the locked one; ``agent_room`` with
    ``fixed_agent_room``), PickupAbove's door onto the room above is added,
    ``connect_all`` joins the rooms, ``doors_open`` opens every door; then
    the locked door's key in another room, and ``num_objs`` random objects,
    each in a uniform room (PickupAbove's first in ``obj_room``,
    GoToImpUnlock's 2 in each unlocked room). The mission: GoToImpUnlock's
    extra object inside the locked room ([type, color]), Unlock's locked
    door ([DOOR, color]), Open's uniform door ([DOOR, its color]), or a
    uniform one of the objects ([type, color], color −1 with
    ``type_only``). A layout is kept when every object is reachable —
    UnblockPickup's only when some object is not."""
    s, r, c = params.max_room_size, params.min_rooms, params.max_rooms
    pitch, k = s - 1, params.num_objs

    def build(m):
        grid = _lattice(params, pitch, m, device)
        env = torch.arange(m, device=device)
        open0 = torch.zeros((m, (c - 1) * r + c * (r - 1)), dtype=torch.bool, device=device)
        avoid = torch.full((m,), -1, device=device)
        locked = avoid
        if params.locked_room:
            locked = _randint(0, c * r, m, gen, device)
            li, lj = locked % c, locked // c
            walls = torch.stack([li + 1 < c, lj + 1 < r, li > 0, lj > 0], dim=1)
            pickd = _rand_between(torch.zeros_like(li), walls.sum(1), gen)
            d = (walls.cumsum(1) > pickd[:, None]).to(torch.uint8).argmax(1)
            x, y = _wall_door(pitch, li, lj, d, _randint(1, s - 1, m, gen, device))
            lcolor = _randint(0, 6, m, gen, device)
            grid[env, x, y] = _cell(DOOR, lcolor, LOCKED, device)
            _open_edge(open0, c, r, li, lj, d)
            avoid = torch.where(_randint(0, 2, m, gen, device) == 1, lcolor, -1)
        if params.fixed_agent_room:
            ai, aj = params.agent_room
        elif params.locked_room:
            a0 = _randint(0, c * r - 1, m, gen, device)
            a0 = a0 + (a0 >= locked).long()
            ai, aj = a0 % c, a0 // c
        else:
            ai, aj = _randint(0, c, m, gen, device), _randint(0, r, m, gen, device)
        agent_pos = _sample_free_cell((grid[..., 0] == EMPTY)
                                      & _room_interior(params, pitch, ai, aj, device), gen)
        agent_dir = _randint(0, 4, m, gen, device)
        if params.predoor[0] >= 0:
            pi, pj, pd = (torch.full((m,), v, device=device) for v in params.predoor)
            x, y = _wall_door(pitch, pi, pj, pd, _randint(1, s - 1, m, gen, device))
            grid[env, x, y] = _cell(DOOR, _randint(0, 6, m, gen, device), CLOSED, device)
            _open_edge(open0, c, r, pi, pj, pd)
        grid = _connect_all(grid, pitch, c, r, open0, gen, avoid)
        if params.doors_open:
            grid[..., 2] = torch.where(grid[..., 0] == DOOR, OPEN,
                                       grid[..., 2].long()).to(torch.int8)
        free = grid[..., 0] == EMPTY
        free[env, agent_pos[:, 0], agent_pos[:, 1]] = False
        if params.locked_room:
            k0 = _randint(0, c * r - 1, m, gen, device)
            k0 = k0 + (k0 >= locked).long()
            _put(grid, free, _room_interior(params, pitch, k0 % c, k0 // c, device),
                 _cell(KEY, lcolor, 0, device), gen)
        types, colors = _random_objects(m, k, gen, device)
        for i in range(k):
            if i == 0 and params.obj_room[0] >= 0:
                room = _room_interior(params, pitch, *params.obj_room, device)
            elif params.dists_per_room:
                rr = torch.full((m,), i // 2, device=device)
                rr = rr + (rr >= locked).long()
                room = _room_interior(params, pitch, rr % c, rr // c, device)
            else:
                room = _room_interior(params, pitch, _randint(0, c, m, gen, device),
                                      _randint(0, r, m, gen, device), device)
            _put(grid, free, room, _cell(types[:, i], colors[:, i], 0, device), gen)
        if params.target_in_locked:
            tt, tc = (v[:, 0] for v in _random_objects(m, 1, gen, device))
            _put(grid, free, _room_interior(params, pitch, li, lj, device),
                 _cell(tt, tc, 0, device), gen)
            target = _target(m, device, tt, tc)
        elif params.locked_room:
            target = _target(m, device, DOOR, lcolor)
        elif params.success == "babyai_open_color":
            dpos = _sample_free_cell(grid[..., 0] == DOOR, gen)
            target = _target(m, device, DOOR, grid[env, dpos[:, 0], dpos[:, 1], 1])
        else:
            t = _randint(0, k, m, gen, device)
            color = torch.full((m,), -1, device=device) if params.type_only else colors[env, t]
            target = _target(m, device, types[env, t], color)
        return grid, agent_pos, agent_dir, target

    def accept(out):
        reachable = _objs_reachable(out[0], out[1])
        return ~reachable if params.invert_reach else reachable

    attempts = BABYAI_UNBLOCK_ATTEMPTS if params.invert_reach else BABYAI_ATTEMPTS
    grid, agent_pos, agent_dir, target = _rejection(build, n, accept, attempts, params.kind)
    return _state(grid, agent_pos, agent_dir, target)


def _reset_babyai_unlocklocal(params: EnvParams, n: int, gen: torch.Generator,
                              device) -> EnvState:
    """UnlockLocal[Dist] / KeyInBox: a 3×3 RoomGrid of 8×8 rooms; one LOCKED
    random-color door on a random wall of the center room, its key inside —
    loose, or in a random-color box whose state is color + 1 (KeyInBox) —
    then ``num_objs`` distractors distinct from each other and from the key,
    then the agent. ``target`` = [DOOR, −1, 0…]: any door (the JAX package's
    ``_reset_babyai_unlocklocal``)."""
    grid = _lattice(params, 7, n, device)
    env = torch.arange(n, device=device)
    d = _randint(0, 4, n, gen, device)
    dx, dy = _wall_door(7, 1, 1, d, _randint(1, 7, n, gen, device))
    color = _randint(0, 6, n, gen, device)
    grid[env, dx, dy] = _cell(DOOR, color, LOCKED, device)
    free = (grid[..., 0] == EMPTY) & _room_interior(params, 7, 1, 1, device)
    if params.key_in_box:
        key = _cell(BOX, _randint(0, 6, n, gen, device), color + 1, device)
    else:
        key = _cell(KEY, color, 0, device)
    _put(grid, free, None, key, gen)
    if params.num_objs:  # distinct from each other and the key (row 0 of the 3×6 table)
        types, colors = _distinct_objects(n, params.num_objs, gen, device, skip=(color,))
        for i in range(params.num_objs):
            _put(grid, free, None, _cell(types[:, i], colors[:, i], 0, device), gen)
    agent_pos = _take(free, None, gen)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device),
                  _target(n, device, DOOR, -1))


def _reset_babyai_u2u(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """UnlockToUnlock: three 6×6 rooms in a row (16×6, walls at x = 5 and
    10); door A (the first of two distinct colors) LOCKS left↔middle, door B
    middle↔right; key A in the right room, key B in the middle, a random
    ball in the left, the agent in the middle. ``target`` = [BALL, −1, 0…]
    (the JAX package's ``_reset_babyai_u2u``)."""
    w, h = params.width, params.height
    grid = _base_grid(params, n, device, goal=False)
    grid[:, 5] = grid[:, 10] = _cell(WALL, GREY, 0, device)
    env = torch.arange(n, device=device)
    pair = torch.argsort(torch.rand((n, 6), generator=gen, device=device), dim=1)[:, :2]
    grid[env, 5, _randint(1, h - 1, n, gen, device)] = _cell(DOOR, pair[:, 0], LOCKED, device)
    grid[env, 10, _randint(1, h - 1, n, gen, device)] = _cell(DOOR, pair[:, 1], LOCKED, device)
    xs, _ = _coords(w, h, device)
    left, mid, right = xs < 5, (xs > 5) & (xs < 10), xs > 10
    free = grid[..., 0] == EMPTY
    _put(grid, free, right, _cell(KEY, pair[:, 0], 0, device), gen)
    _put(grid, free, mid, _cell(KEY, pair[:, 1], 0, device), gen)
    _put(grid, free, left, _cell(BALL, _randint(0, 6, n, gen, device), 0, device), gen)
    agent_pos = _sample_free_cell(free & mid, gen)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device), _target(n, device, BALL, -1))


def _reset_babyai_objdoor(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """GoToDoor / GoToObjDoor / ActionObjDoor: a 3×3 RoomGrid; the center
    room's four doors in independent random colors, the agent and then
    ``num_objs`` objects inside (random, or distinct for ActionObjDoor). The
    mission names a uniform one of the doors and objects: ``target`` =
    [type, color, 0…]; ActionObjDoor's draws a verb by a coin as well, goto
    or open for a door, goto or pickup for an object: ``target`` = [verb (0
    goto, 1 pickup, 2 open), type, color, 0…] (the JAX package's
    ``_reset_babyai_objdoor`` and ``_reset_babyai_actionobj``)."""
    pitch, k = (params.width - 1) // 3, params.num_objs
    action = params.success == "babyai_action"
    grid = _lattice(params, pitch, n, device)
    if action:
        types, colors = _distinct_objects(n, k, gen, device)
    else:
        types, colors = _random_objects(n, k, gen, device)
    dcols = _randint(0, 6, (n, 4), gen, device)
    _center_doors(grid, pitch, dcols, gen)
    free = (grid[..., 0] == EMPTY) & _room_interior(params, pitch, 1, 1, device)
    agent_pos = _take(free, None, gen)
    for i in range(k):
        _put(grid, free, None, _cell(types[:, i], colors[:, i], 0, device), gen)
    env = torch.arange(n, device=device)
    pick = _randint(0, k + 4, n, gen, device)
    is_door = pick >= k
    di, oi = (pick - k).clamp(0, 3), pick.clamp(0, max(k - 1, 0))
    if k:
        ttype = torch.where(is_door, DOOR, types[env, oi])
        tcol = torch.where(is_door, dcols[env, di], colors[env, oi])
    else:
        ttype, tcol = torch.full((n,), DOOR, device=device), dcols[env, di]
    target = (ttype, tcol)
    if action:
        verb = torch.where(_randint(0, 2, n, gen, device) == 0, 0, torch.where(is_door, 2, 1))
        target = (verb, *target)
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device), _target(n, device, *target))


def _reset_babyai_putnext2(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """PutNextS{s}N{n}[Carrying]: two s×s rooms without their dividing wall
    ((2s − 1)×s); the agent in the left half, then ``num_objs`` objects in
    each half, all 2·num_objs distinct. The mission puts a uniform left
    object next to a uniform right one, or (a coin) the other way round:
    ``target`` = [move_type, move_color, fixed_type, fixed_color, 0…]; with
    ``start_carrying`` the move object starts in the agent's hand, its cell
    emptied. MoveTwoAcross (``babyai_seq``) asks for two moves instead,
    before(put a uniform left object next to a uniform right one, put a
    uniform right object next to a uniform left one) in slots 0 and 2 of
    ``instr`` (the JAX package's ``_reset_babyai_putnext2``)."""
    s, k = params.max_room_size, params.num_objs
    grid = _base_grid(params, n, device, goal=False)
    types, colors = _distinct_objects(n, 2 * k, gen, device)
    xs, _ = _coords(params.width, params.height, device)
    free = grid[..., 0] == EMPTY
    agent_pos = _take(free, xs < s - 1, gen)
    cells = torch.stack([_put(grid, free, xs < s - 1 if i < k else xs > s - 1,
                              _cell(types[:, i], colors[:, i], 0, device), gen)
                         for i in range(2 * k)], dim=1)
    env = torch.arange(n, device=device)
    ia = _randint(0, k, n, gen, device)
    ib = k + _randint(0, k, n, gen, device)
    if params.success == "babyai_seq":
        # MoveTwoAcross: before(put L[a] next to R[b], put R[c] next to L[d])
        ic = k + _randint(0, k, n, gen, device)
        idx = _randint(0, k, n, gen, device)
        instr = torch.zeros((n, 4, 12), dtype=torch.int32, device=device)
        for slot, (mv, fx) in ((0, (ia, ib)), (2, (ic, idx))):
            instr[:, slot, :5] = torch.stack([torch.full_like(mv, 4), types[env, mv],
                                              colors[env, mv], types[env, fx], colors[env, fx]], 1)
        return _state(grid, agent_pos, _randint(0, 4, n, gen, device), _target(n, device, 2),
                      instr)
    flip = _randint(0, 2, n, gen, device) == 1
    mv, fx = torch.where(flip, ib, ia), torch.where(flip, ia, ib)
    state = _state(grid, agent_pos, _randint(0, 4, n, gen, device), _target(
        n, device, types[env, mv], colors[env, mv], types[env, fx], colors[env, fx]))
    if params.start_carrying:
        grid[env, cells[env, mv, 0], cells[env, mv, 1]] = _cell(EMPTY, 0, 0, device)
        state.carrying = _cell(types[env, mv], colors[env, mv], 0, device)
    return state


BABYAI_DESC_ATTEMPTS = 1024  # a slot's description draws (the JAX package's loop has no bound)
_VERB_CODES = {"goto": 1, "open": 2, "pickup": 3, "putnext": 4}


def _loc_masks(grid: torch.Tensor, agent_pos: torch.Tensor, agent_dir: torch.Tensor):
    """[N, 4, W, H]: the cells each of ``LOCATION_WORDS`` names from the
    agent's pose (:func:`door_sides`' rule over every cell)."""
    n, w, h = grid.shape[:3]
    xs, ys = _coords(w, h, grid.device)
    dir_vec = torch.as_tensor(DIR_TO_VEC, device=grid.device)
    d1, d2 = dir_vec[agent_dir], dir_vec[(agent_dir + 1) % 4]
    vx, vy = xs - agent_pos[:, 0, None, None], ys - agent_pos[:, 1, None, None]
    forward = vx * d1[:, 0, None, None] + vy * d1[:, 1, None, None]
    right = vx * d2[:, 0, None, None] + vy * d2[:, 1, None, None]
    return torch.stack([right < 0, right > 0, forward > 0, forward < 0], dim=1)


def _sample_descs(grid: torch.Tensor, agent_pos: torch.Tensor, agent_dir: torch.Tensor,
                  use: torch.Tensor, verbs: tuple, locations: bool,
                  gen: torch.Generator) -> torch.Tensor:
    """BabyAI's ``rand_obj_desc`` for the slots ``use`` [N, 4] marks → the
    ``instr`` rows [N, 4, 12] (the JAX package's ``sample_slot`` of
    ``_reset_babyai_levelgen`` and ``sample_desc`` of
    ``_reset_babyai_pickuploc``): a verb uniform over ``verbs``, a type
    uniform over its pool (goto: key, ball, box or door; open: door; pickup
    and putnext: key, ball or box), a color or none (1/7), and where
    ``locations`` and the verb is not putnext, a location word with
    probability 1/2, fixed against the agent's start pose; a putnext draws a
    second description of a movable object. A slot is drawn again until its
    description matches some object, and a putnext until its second does
    too and the two do not both denote one and the same single object; the
    slots drawn again are only the rejected ones, and a slot rejected
    ``BABYAI_DESC_ATTEMPTS`` times raises. A description with a location
    word keeps the packed positions of its matches, the 6 largest (its
    type and color read −1)."""
    n, w, h = grid.shape[:3]
    device = grid.device
    g0, g1 = grid[..., 0].long(), grid[..., 1].long()
    loc_masks = _loc_masks(grid, agent_pos, agent_dir)
    xs, ys = _coords(w, h, device)
    packed_cells = (xs * h + ys + 1).reshape(1, w, h)
    allowed = torch.tensor([_VERB_CODES[v] for v in verbs], device=device)
    movable = torch.tensor(_OBJ_TYPES, device=device)
    four = torch.tensor((*_OBJ_TYPES, DOOR), device=device)
    rows = torch.zeros((n, 4, 12), dtype=torch.int64, device=device)
    todo = use.clone()
    for _ in range(BABYAI_DESC_ATTEMPTS):
        idx = todo.nonzero()
        if idx.numel() == 0:
            return rows.to(torch.int32)
        e, k = idx[:, 0], idx.shape[0]
        verb = allowed[_randint(0, allowed.numel(), k, gen, device)]
        t3 = movable[_randint(0, 3, k, gen, device)]
        t4 = four[_randint(0, 4, k, gen, device)]
        t = torch.where(verb == 2, DOOR, torch.where(verb == 1, t4, t3))
        col = _randint(-1, 6, k, gen, device)
        loc = torch.full((k,), -1, device=device)
        if locations:
            coin = _randint(0, 2, k, gen, device) == 1
            loc = torch.where(coin & (verb != 4), _randint(0, 4, k, gen, device), -1)
        b = lambda v: v[:, None, None]  # noqa: E731
        ge0, ge1 = g0[e], g1[e]
        mask = (ge0 == b(t)) & ((b(col) < 0) | (ge1 == b(col)))
        mask &= torch.where(b(loc) >= 0, loc_masks[e, loc.clamp(0, 3)], True)
        t2 = movable[_randint(0, 3, k, gen, device)]
        c2 = _randint(-1, 6, k, gen, device)
        mask2 = (ge0 == b(t2)) & ((b(c2) < 0) | (ge1 == b(c2)))
        flat, flat2 = mask.flatten(1), mask2.flatten(1)
        single_same = ((flat.sum(1) == 1) & (flat2.sum(1) == 1)
                       & (flat.to(torch.uint8).argmax(1) == flat2.to(torch.uint8).argmax(1)))
        ok = flat.any(1)
        ok = torch.where(verb == 4, ok & flat2.any(1) & ~single_same, ok)
        positional = loc >= 0
        top = torch.where(mask, packed_cells, 0).flatten(1).sort(1, descending=True).values[:, :6]
        row = torch.zeros((k, 12), dtype=torch.int64, device=device)
        row[:, 0] = verb
        row[:, 1] = torch.where(positional, -1, t)
        row[:, 2] = torch.where(positional, -1, col)
        row[:, 3] = torch.where(verb == 4, t2, 0)
        row[:, 4] = torch.where(verb == 4, c2, 0)
        row[:, 5] = positional.long()
        row[:, 6:] = torch.where(positional[:, None], top, 0)
        kept = idx[ok]
        rows[kept[:, 0], kept[:, 1]] = row[ok]
        todo[kept[:, 0], kept[:, 1]] = False
    if bool(todo.any()):
        raise RuntimeError(f"BabyAI instruction: {int(todo.sum())} slots drew "
                           f"{BABYAI_DESC_ATTEMPTS} descriptions that match no object")
    return rows.to(torch.int32)


def _reset_babyai_levelgen(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """BabyAI's LevelGen (GoToSeq[S5R2], Synth[S5R2], SynthLoc, SynthSeq,
    MiniBossLevel, BossLevel[NoUnlock]; the JAX package's
    ``_reset_babyai_levelgen``): a C×R RoomGrid of S×S rooms; with
    probability ``locked_room_prob`` a LOCKED random-color door on a random
    wall of a random room; the agent in a uniform room (not the locked
    one); ``connect_all`` (the locked door counting as a connection); the
    locked door's key in another room; ``num_objs`` random objects, each in
    a uniform room; with ``check_reachable`` a layout is kept only when every
    object is reachable. Then ``rand_instr``: a kind uniform over
    ``instr_kinds`` — action (slot 0), and (slots 0-1), or seq, before or
    after by a coin, of halves A (slot 0, and slot 1 by a coin) and B (slot
    2, and slot 3 by a coin) — with each used slot's description from
    :func:`_sample_descs`; ``target`` = [comp, 0…]."""
    s, r, c = params.max_room_size, params.min_rooms, params.max_rooms
    pitch, k = s - 1, params.num_objs
    lock = params.locked_room_prob > 0

    def interior(i, j):
        return _room_interior(params, pitch, i, j, device)

    def build(m):
        grid = _lattice(params, pitch, m, device)
        env = torch.arange(m, device=device)
        open0 = torch.zeros((m, (c - 1) * r + c * (r - 1)), dtype=torch.bool, device=device)
        if lock:
            has_lock = torch.rand(m, generator=gen, device=device) < params.locked_room_prob
            locked = _randint(0, c * r, m, gen, device)
            li, lj = locked % c, locked // c
            walls = torch.stack([li + 1 < c, lj + 1 < r, li > 0, lj > 0], dim=1)
            pickd = _rand_between(torch.zeros_like(li), walls.sum(1), gen)
            d = (walls.cumsum(1) > pickd[:, None]).to(torch.uint8).argmax(1)
            x, y = _wall_door(pitch, li, lj, d, _randint(1, s - 1, m, gen, device))
            lcolor = _randint(0, 6, m, gen, device)
            grid[env, x, y] = torch.where(has_lock[:, None], _cell(DOOR, lcolor, LOCKED, device),
                                          grid[env, x, y])
            open0[env, _edge(c, r, li, lj, d)] |= has_lock
            a0 = _randint(0, c * r - 1, m, gen, device)
            ar = torch.where(has_lock, a0 + (a0 >= locked).long(),
                             _randint(0, c * r, m, gen, device))
        else:
            ar = _randint(0, c * r, m, gen, device)
        agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & interior(ar % c, ar // c), gen)
        agent_dir = _randint(0, 4, m, gen, device)
        grid = _connect_all(grid, pitch, c, r, open0, gen)
        free = grid[..., 0] == EMPTY
        free[env, agent_pos[:, 0], agent_pos[:, 1]] = False
        if lock:
            k0 = _randint(0, c * r - 1, m, gen, device)
            k0 = k0 + (k0 >= locked).long()
            kpos = _sample_free_cell(free & interior(k0 % c, k0 // c), gen)
            grid[env, kpos[:, 0], kpos[:, 1]] = torch.where(
                has_lock[:, None], _cell(KEY, lcolor, 0, device), grid[env, kpos[:, 0], kpos[:, 1]])
            free[env, kpos[:, 0], kpos[:, 1]] &= ~has_lock
        types, colors = _random_objects(m, k, gen, device)
        for i in range(k):
            room = interior(_randint(0, c, m, gen, device), _randint(0, r, m, gen, device))
            _put(grid, free, room, _cell(types[:, i], colors[:, i], 0, device), gen)
        return grid, agent_pos, agent_dir

    if params.check_reachable:
        grid, agent_pos, agent_dir = _rejection(
            build, n, lambda o: _objs_reachable(o[0], o[1]), BABYAI_ATTEMPTS, params.kind)
    else:
        grid, agent_pos, agent_dir = build(n)
    kinds = params.instr_kinds.split(",")
    codes = torch.tensor([{"action": 0, "and": 1, "seq": 2}[x] for x in kinds], device=device)
    kind = codes[_randint(0, len(kinds), n, gen, device)]
    comp = torch.where(kind == 2, 2 + _randint(0, 2, n, gen, device), kind)
    a_and = (kind == 2) & (_randint(0, 2, n, gen, device) == 1)
    b_and = (kind == 2) & (_randint(0, 2, n, gen, device) == 1)
    use = torch.stack([torch.ones_like(a_and), (kind == 1) | a_and, kind == 2,
                       (kind == 2) & b_and], dim=1)
    instr = _sample_descs(grid, agent_pos, agent_dir, use, tuple(params.action_kinds.split(",")),
                          params.locations, gen)
    return _state(grid, agent_pos, agent_dir, _target(n, device, comp), instr)


def _reset_babyai_twodoors(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """OpenTwoDoors / OpenRedBlueDoors[Debug] / OpenDoorsOrderN{2,4}[Debug]
    (the JAX package's ``_reset_babyai_twodoors``): a 3×3 RoomGrid of 6×6
    rooms whose center room gets CLOSED doors of distinct colors (the first
    of a permutation of the six, or ``first_color``/``second_color``), one
    a wall at a uniform offset, the agent inside. ``comp="before"``: door 1
    west and door 2 east, before(open door 1, open door 2), the first strict
    in Debug. Otherwise ``num_objs`` doors on distinct random walls, an
    ordered pair of them, and a uniform mode: open door 1 (comp 0), door 1
    before door 2 (2) or door 1 after door 2 (3), both strict in Debug.
    ``instr`` slots 0 and 2 hold OpenInstr(door, color); ``target`` =
    [comp, 0…]."""
    grid = _lattice(params, 5, n, device)
    env = torch.arange(n, device=device)
    colors = torch.argsort(torch.rand((n, 6), generator=gen, device=device), dim=1)
    if params.first_color >= 0:
        colors[:, 0], colors[:, 1] = params.first_color, params.second_color
    offs = _randint(6, 10, (n, 4), gen, device)
    full = lambda v: torch.full((n,), v, device=device)  # noqa: E731
    wx = torch.stack([full(10), offs[:, 1], full(5), offs[:, 3]], dim=1)  # east, south, west, north
    wy = torch.stack([offs[:, 0], full(10), offs[:, 2], full(5)], dim=1)
    strict = 2 if params.strict else 0
    if params.comp == "before":
        n_doors, strict2 = 2, 0  # upstream stricts only the first OpenInstr
        walls = torch.tensor([2, 0], device=device).expand(n, 2)
        order = torch.tensor([0, 1], device=device).expand(n, 2)
        comp = full(2)
    else:
        n_doors, strict2 = params.num_objs, strict
        walls = torch.argsort(torch.rand((n, 4), generator=gen, device=device), dim=1)[:, :n_doors]
        order = torch.argsort(torch.rand((n, n_doors), generator=gen, device=device), dim=1)[:, :2]
        comp = torch.tensor([0, 2, 3], device=device)[_randint(0, 3, n, gen, device)]
    for i in range(n_doors):
        grid[env, wx[env, walls[:, i]], wy[env, walls[:, i]]] = _cell(DOOR, colors[:, i], CLOSED,
                                                                      device)
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & _room_interior(params, 5, 1, 1, device),
                                  gen)
    instr = torch.zeros((n, 4, 12), dtype=torch.int32, device=device)
    for slot, o, st in ((0, order[:, 0], strict), (2, order[:, 1], strict2)):
        instr[:, slot, 0], instr[:, slot, 1], instr[:, slot, 5] = 2, DOOR, st
        instr[:, slot, 2] = colors[env, o].int()
    instr[:, 2] *= (comp >= 2).int()[:, None]  # comp 0: slot 2 absent
    return _state(grid, agent_pos, _randint(0, 4, n, gen, device), _target(n, device, comp), instr)


def _reset_babyai_pickuploc(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """PickupLoc (the JAX package's ``_reset_babyai_pickuploc``): BabyAI's
    single 8×8 room with the agent and ``num_objs`` random objects,
    reachability rejected; PickupInstr in slot 0 on a description of
    :func:`_sample_descs` with location words; ``target`` zeros (comp 0)."""
    grid, agent_pos, agent_dir, _, _ = _babyai_room(
        params, n, gen, device, lambda m: _random_objects(m, params.num_objs, gen, device))
    use = torch.zeros((n, 4), dtype=torch.bool, device=device)
    use[:, 0] = True
    instr = _sample_descs(grid, agent_pos, agent_dir, use, ("pickup",), True, gen)
    return _state(grid, agent_pos, agent_dir, None, instr)


_RESETS = {
    "empty": _reset_empty, "doorkey": _reset_doorkey, "fourrooms": _reset_fourrooms,
    "lavagap": _reset_lavagap, "distshift": _reset_distshift, "redblue": _reset_redblue,
    "lockedroom": _reset_lockedroom, "crossing": _reset_crossing, "dynobs": _reset_dynobs,
    "unlock": _reset_unlock, "keycorridor": _reset_keycorridor, "multiroom": _reset_multiroom,
    "obstructedfull": _reset_obstructedfull, "playground": _reset_playground,
    "memory": _reset_memory, "gotodoor": _reset_gotodoor, "fetch": _reset_fetch,
    "gotoobject": _reset_gotoobject, "putnear": _reset_putnear,
    "babyai_goto": _reset_babyai_goto, "babyai_putnext": _reset_babyai_putnext,
    "babyai_pickup": _reset_babyai_pickup, "babyai_openred": _reset_babyai_openred,
    "babyai_opendoor": _reset_babyai_opendoor, "babyai_actionobj": _reset_babyai_objdoor,
    "babyai_gotomaze": _reset_babyai_gotomaze, "babyai_unlocklocal": _reset_babyai_unlocklocal,
    "babyai_u2u": _reset_babyai_u2u, "babyai_objdoor": _reset_babyai_objdoor,
    "babyai_putnext2": _reset_babyai_putnext2, "babyai_levelgen": _reset_babyai_levelgen,
    "babyai_twodoors": _reset_babyai_twodoors, "babyai_pickuploc": _reset_babyai_pickuploc,
}


def reset(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """Fresh states for ``n`` environments."""
    if params.kind not in _RESETS:
        raise ValueError(params.kind)
    return _RESETS[params.kind](params, n, gen, device)


def select(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per env: ``a`` where ``mask`` [N] is true, else ``b``."""
    def pick(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)

    return EnvState(*(pick(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(EnvState)))


def take(state: EnvState, start: int, stop: int) -> EnvState:
    """Envs ``start:stop`` of ``state`` (views, no copy)."""
    return EnvState(*(getattr(state, f.name)[start:stop] for f in dataclasses.fields(EnvState)))


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def _can_overlap(cell: torch.Tensor) -> torch.Tensor:
    obj, state = cell[..., 0], cell[..., 2]
    return ((obj == EMPTY) | (obj == FLOOR) | (obj == GOAL) | (obj == LAVA)
            | ((obj == DOOR) & (state == OPEN)))


_NEIGHBORHOOD = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def obstacle_gumbels(params: EnvParams, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """One step's Dynamic-Obstacles draws: [N, n_obstacles, 9] standard
    Gumbel noise, one per ball and cell of its 3×3 neighborhood (x-major,
    as the JAX package's ``jax.random.categorical`` draws it)."""
    u = torch.rand((n, params.n_obstacles, len(_NEIGHBORHOOD)), generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(float(np.finfo(np.float32).tiny))))


def _move_obstacles(params: EnvParams, state: EnvState, gumbels: torch.Tensor) -> torch.Tensor:
    """Dynamic-Obstacles pre-step: each ball moves to a uniformly random
    free cell of its 3×3 neighborhood (own cell and the agent's excluded,
    like upstream's ``place_obj(top=old-1, size=(3,3))`` rejection loop);
    a fully blocked ball stays. Balls move one after another in x-major
    order of their cells before the step, each seeing the earlier balls'
    new positions (upstream dynamicobstacles.py step()). The pick is the
    argmax of ``gumbels`` over the free cells. Returns the new grid."""
    grid = state.grid.clone()
    n, w, h = grid.shape[:3]
    device = grid.device
    env = torch.arange(n, device=device)
    # Ball cells in x-major order (cell 0 for missing balls, as the JAX
    # package's nonzero(size=n_obstacles, fill_value=0) gives).
    is_ball = (grid[..., 0] == BALL).reshape(n, -1)
    order = torch.argsort((~is_ball).to(torch.uint8), dim=1, stable=True)[:, :params.n_obstacles]
    have = torch.arange(params.n_obstacles, device=device) < is_ball.sum(1, keepdim=True)
    ball_idx = torch.where(have, order, 0)
    offs = torch.as_tensor(_NEIGHBORHOOD, device=device)
    ax, ay = state.agent_pos[:, 0, None], state.agent_pos[:, 1, None]
    empty, ball = _cell(EMPTY, 0, 0, device), _cell(BALL, BLUE, 0, device)
    for i in range(params.n_obstacles):
        bx, by = ball_idx[:, i] // h, ball_idx[:, i] % h
        raw_x, raw_y = bx[:, None] + offs[:, 0], by[:, None] + offs[:, 1]
        cx, cy = raw_x.clamp(0, w - 1), raw_y.clamp(0, h - 1)
        valid = ((raw_x == cx) & (raw_y == cy) & (grid[env[:, None], cx, cy, 0] == EMPTY)
                 & ~((cx == ax) & (cy == ay)))
        any_valid = valid.any(1)
        pick = torch.where(valid, gumbels[:, i], float("-inf")).argmax(1)
        nx = torch.where(any_valid, cx[env, pick], bx)
        ny = torch.where(any_valid, cy[env, pick], by)
        grid[env, bx, by] = torch.where(any_valid[:, None], empty, grid[env, bx, by])
        grid[env, nx, ny] = ball
    return grid


def _door_open(grid: torch.Tensor, color: int) -> torch.Tensor:
    """[N]: some door of ``color`` is open."""
    return ((grid[..., 0] == DOOR) & (grid[..., 1] == color) & (grid[..., 2] == OPEN)).flatten(1).any(1)


def _time_reward(step_count: torch.Tensor, max_steps: int) -> torch.Tensor:
    """``1 - 0.9 * step_count / max_steps`` in float32 as the JAX package's
    compiled step computes it: ``1 - step_count * k`` with ``k =
    f32(0.9) / f32(max_steps)``, rounded once (a fused multiply-subtract),
    which float64 holds exactly."""
    k = float(np.float32(0.9) / np.float32(max_steps))
    return (1.0 - step_count.double() * k).float()


def _babyai_verify(params: EnvParams, state: EnvState, action, grid, new_pos, new_dir, fx, fy,
                   fobj, fcol, does_pickup, carrying):
    """BabyAI's verifier of a single instruction, after the transition (the
    JAX package's ``step``, :4150-4275) → (success [N], strict failure [N]).
    ``target`` holds the mission; −1 in it is a wildcard where the mode
    reads one. The agent never moves on a pickup, drop or toggle, so
    (``fx``, ``fy``) is then its front cell.

    - ``babyai_goto`` (GoToInstr, verified on every action): the cell in
      front after the step matches [type, color], or the agent picked up a
      matching object it faced (the verifier's stale position list).
    - ``babyai_putnext``: on a drop ACTION, successful or not, some object
      matching the move pair sits cardinally next to one matching the
      fixed pair (``roll``: objects never sit on the border).
    - ``babyai_pickup``: a pickup action that leaves the agent carrying a
      match; ``strict`` fails one that leaves it carrying anything else.
    - ``babyai_open_color``: a toggle that leaves an open door of the
      mission's color (−1 any) in front.
    - ``babyai_open``: a toggle that leaves an open door in front whose
      ``x·height + y + 1`` is in ``target[:4]``; ``strict`` fails any other
      toggle of a door.
    - ``babyai_action``: ``target[0]`` picks goto (0), pickup (1) or open
      (2), each on the pair [type, color] = ``target[1:3]``."""
    t = state.target
    n, w, h = grid.shape[:3]
    env = torch.arange(n, device=grid.device)
    mode = params.success
    no = torch.zeros_like(action, dtype=torch.bool)
    cell = grid[env, fx, fy]  # the front cell after a toggle, pickup or drop
    if mode in ("babyai_goto", "babyai_action"):
        ttype, tcol = (t[:, 0], t[:, 1]) if mode == "babyai_goto" else (t[:, 1], t[:, 2])
        front = new_pos + torch.as_tensor(DIR_TO_VEC, device=grid.device)[new_dir]
        ncell = grid[env, front[:, 0].clamp(0, w - 1), front[:, 1].clamp(0, h - 1)]
        goto = (((ncell[:, 0].int() == ttype) & (ncell[:, 1].int() == tcol))
                | (does_pickup & (fobj.int() == ttype) & (fcol.int() == tcol)))
        if mode == "babyai_goto":
            return goto, no
        pick = ((action == A_PICKUP) & (carrying[:, 0].int() == ttype)
                & (carrying[:, 1].int() == tcol))
        opened = ((action == A_TOGGLE) & (cell[:, 0] == DOOR) & (cell[:, 1].int() == tcol)
                  & (cell[:, 2] == OPEN))
        verb = t[:, 0]
        return torch.where(verb == 0, goto, torch.where(verb == 1, pick, opened)), no
    if mode == "babyai_putnext":
        obj, col = grid[..., 0].int(), grid[..., 1].int()
        is_a = (obj == t[:, 0, None, None]) & (col == t[:, 1, None, None])
        is_b = (obj == t[:, 2, None, None]) & (col == t[:, 3, None, None])
        near_b = is_b.roll(1, 1) | is_b.roll(-1, 1) | is_b.roll(1, 2) | is_b.roll(-1, 2)
        return (action == A_DROP) & (is_a & near_b).flatten(1).any(1), no
    if mode == "babyai_pickup":
        match = ((carrying[:, 0] != 0) & ((t[:, 0] < 0) | (carrying[:, 0].int() == t[:, 0]))
                 & ((t[:, 1] < 0) | (carrying[:, 1].int() == t[:, 1])))
        succ = (action == A_PICKUP) & match
        fail = (action == A_PICKUP) & (carrying[:, 0] != 0) & ~match if params.strict else no
        return succ, fail
    if mode == "babyai_open_color":
        return ((action == A_TOGGLE) & (cell[:, 0] == DOOR)
                & ((t[:, 1] < 0) | (cell[:, 1].int() == t[:, 1])) & (cell[:, 2] == OPEN)), no
    if mode == "babyai_open":
        packed = (fx * h + fy + 1).int()
        in_set = (t[:, :4] == packed[:, None]).any(1)
        succ = (action == A_TOGGLE) & (cell[:, 0] == DOOR) & (cell[:, 2] == OPEN) & in_set
        fail = (action == A_TOGGLE) & (cell[:, 0] == DOOR) & ~succ if params.strict else no
        return succ, fail
    raise ValueError(f"unknown BabyAI success mode {mode!r}")


def _seq_verify(params: EnvParams, state: EnvState, action, grid, new_pos, new_dir, fx, fy,
                fobj, fcol, does_pickup, does_drop, carrying):
    """BabyAI's composite-instruction verifier (``success="babyai_seq"``), after
    the transition, for every env and its four ``instr`` slots at once (the
    JAX package's ``_seq_verify``, upstream verifier.py for trees up to
    Seq(And(a, b), And(c, d))) → (success [N], failure [N], instr,
    instr_state).

    Each slot's atomic status this step: goto — the front cell after the
    step matches, or the agent picked up a match it faced; open — a toggle
    that leaves a matching door open in front (strict fails another toggle
    of a door in front); pickup — a pickup that leaves the agent carrying a
    match (strict fails a pickup action that holds anything else); putnext —
    a drop ACTION with a move-description object cardinally next to a
    fixed-description one. A positional slot (flag bit 0) matches its packed
    positions instead: goto and open the front cell, pickup a pickup from a
    position of the set, which marks the slot's carry; a drop action takes
    the marked position out of the set, and a drop of the tracked object
    puts its landing cell in the first free entry (capacity 6).

    Composition over the done latches: and(0, 1) latches each slot until
    both are done; before(A, B) verifies A until it is done, then B — B
    also on the step A completes, and before that too where B is an and
    (its latches accumulate) or the SeqInstr is strict (completing B first
    then fails); after(A, B) is before(B, A). Failures count from the half
    being verified."""
    n = grid.shape[0]
    device = grid.device
    env = torch.arange(n, device=device)
    instr = state.instr
    verbs, ta, ca, tb, cb = (instr[..., i] for i in range(5))
    positional = (instr[..., 5] & 1) == 1
    strict = (instr[..., 5] & 2) == 2
    pos_set = instr[..., 6:12]                     # [N, 4, 6]
    comp, seq_strict = state.target[:, 0], state.target[:, 1] > 0
    h = params.height

    def match(t_arr, c_arr, otype, ocol):
        return (((t_arr < 0) | (otype.int()[:, None] == t_arr))
                & ((c_arr < 0) | (ocol.int()[:, None] == c_arr)))

    def in_set(packed):
        return (pos_set == packed.int()[:, None, None]).any(-1)

    front = new_pos + torch.as_tensor(DIR_TO_VEC, device=device)[new_dir]
    nfx, nfy = front[:, 0].clamp(0, params.width - 1), front[:, 1].clamp(0, h - 1)
    ncell = grid[env, nfx, nfy]
    fxy_packed = fx * h + fy + 1
    goto_succ = torch.where(positional, in_set(nfx * h + nfy + 1),
                            match(ta, ca, ncell[:, 0], ncell[:, 1])
                            | (does_pickup[:, None] & match(ta, ca, fobj, fcol)))
    cell = grid[env, fx, fy]
    toggles_door = (action == A_TOGGLE) & (cell[:, 0] == DOOR)
    open_succ = (toggles_door & (cell[:, 2] == OPEN))[:, None] & torch.where(
        positional, in_set(fxy_packed), match(ta, ca, torch.full_like(fobj, DOOR), cell[:, 1]))
    open_fail = strict & toggles_door[:, None] & ~open_succ
    carry_from_set = does_pickup[:, None] & in_set(fxy_packed)
    pick_succ = torch.where(positional, carry_from_set,
                            does_pickup[:, None] & match(ta, ca, carrying[:, 0], carrying[:, 1]))
    pick_fail = strict & ((action == A_PICKUP) & (carrying[:, 0] != 0))[:, None] & ~pick_succ
    g0, g1 = grid[:, None, :, :, 0].int(), grid[:, None, :, :, 1].int()  # [N, 1, W, H]
    real = (g0 != WALL) & (g0 != EMPTY)
    b = lambda v: v[..., None, None]  # noqa: E731
    is_a = ((b(ta) < 0) | (g0 == b(ta))) & ((b(ca) < 0) | (g1 == b(ca))) & real
    is_b = ((b(tb) < 0) | (g0 == b(tb))) & ((b(cb) < 0) | (g1 == b(cb))) & real
    near_b = is_b.roll(1, 2) | is_b.roll(-1, 2) | is_b.roll(1, 3) | is_b.roll(-1, 3)
    put_succ = (action == A_DROP)[:, None] & (is_a & near_b).flatten(2).any(-1)
    succ_step = (((verbs == 1) & goto_succ) | ((verbs == 2) & open_succ)
                 | ((verbs == 3) & pick_succ) | ((verbs == 4) & put_succ))
    fail_step = ((verbs == 2) & open_fail) | ((verbs == 3) & pick_fail)

    # positional tracking, on the action (upstream update_objs_poss)
    carry_pos = state.instr_state[..., 1]
    new_carry = torch.where(carry_from_set & (carry_pos == 0), fxy_packed.int()[:, None], carry_pos)
    set_after = torch.where((action == A_DROP)[:, None, None] & (carry_pos[..., None] > 0)
                            & (pos_set == carry_pos[..., None]), 0, pos_set)
    empty = set_after == 0
    first_empty = empty.to(torch.uint8).argmax(-1, keepdim=True)
    add = ((does_drop[:, None] & (new_carry > 0))[..., None]
           & (torch.arange(6, device=device) == first_empty) & empty)
    set_after = torch.where(add, fxy_packed.int()[:, None, None], set_after)
    new_carry = torch.where(does_drop[:, None], 0, new_carry)
    new_instr = instr.clone()
    new_instr[..., 6:12] = set_after

    # composition over the done latches
    present = verbs > 0
    d = state.instr_state[..., 0] > 0
    in_a = torch.arange(4, device=device) < 2
    in_b = ~in_a

    def group_done(dv, lo):
        return (dv[:, lo] | ~present[:, lo]) & (dv[:, lo + 1] | ~present[:, lo + 1])

    def gated(dv, gate):
        return dv | (gate & ~dv & succ_step & present), gate & ~dv & fail_step & present

    def ordered(first_in, then_in, first_lo, then_lo, then_is_and):
        """before(first, then): the latches, success and failure."""
        was = group_done(d, first_lo)
        nd, gf_first = gated(d, first_in & ~was[:, None])
        now = group_done(nd, first_lo)
        nd, gf_then = gated(nd, then_in & (was | now | seq_strict | then_is_and)[:, None])
        then_now = group_done(nd, then_lo)
        succ = (was | now) & then_now
        fail = (torch.where(was, gf_then.any(-1), gf_first.any(-1))
                | (seq_strict & ~was & ~now & then_now))
        return nd, succ, fail

    nd_and, gf_and = gated(d, in_a.expand_as(d))
    nd_b, succ_b, fail_b = ordered(in_a, in_b, 0, 2, present[:, 2] & present[:, 3])
    nd_a, succ_a, fail_a = ordered(in_b, in_a, 2, 0, present[:, 0] & present[:, 1])
    is_seq, is_after = comp >= 2, comp == 3
    succ = torch.where(is_seq, torch.where(is_after, succ_a, succ_b), group_done(nd_and, 0))
    fail = torch.where(is_seq, torch.where(is_after, fail_a, fail_b), gf_and.any(-1))
    new_d = torch.where(is_seq[:, None], torch.where(is_after[:, None], nd_a, nd_b), nd_and)
    return succ, fail, new_instr, torch.stack([new_d.int(), new_carry.int()], dim=-1)


def step(params: EnvParams, state: EnvState, action: torch.Tensor,
         gumbels: Optional[torch.Tensor] = None, gen: Optional[torch.Generator] = None):
    """One transition of every env. Returns (state, reward f32 [N],
    terminated bool [N], truncated bool [N]).

    Dynamic-Obstacles moves its balls first, by the [N, n_obstacles, 9]
    Gumbel draws ``gumbels`` (:func:`obstacle_gumbels`), drawn from ``gen``
    when not given. ``state.target`` is carried unchanged, and so are
    ``instr`` and ``instr_state`` but where the composite verifier updates
    them."""
    device = state.grid.device
    n = state.grid.shape[0]
    env = torch.arange(n, device=device)
    action = action.long()
    if params.success == "memory":
        # Upstream MemoryEnv.step remaps pickup → toggle before the
        # transition, so the fork objects cannot be picked up.
        action = torch.where(action == A_PICKUP, A_TOGGLE, action)
    step_count = state.step_count + 1
    dir_vec = torch.as_tensor(DIR_TO_VEC, device=device)

    if params.kind == "dynobs":
        # Upstream wraps out-of-range actions to 0 (the 3-action space).
        action = torch.where(action >= params.num_actions, 0, action)
        # Collision check uses the PRE-move grid: forward into ANY
        # occupied non-goal cell (walls included — upstream quirk)
        # terminates with −1 after the normal transition.
        pre = state.agent_pos + dir_vec[state.agent_dir]
        pre_obj = state.grid[env, pre[:, 0].clamp(0, params.width - 1),
                             pre[:, 1].clamp(0, params.height - 1), 0]
        not_clear = (pre_obj != EMPTY) & (pre_obj != GOAL)
        if gumbels is None:
            gumbels = obstacle_gumbels(params, n, gen, device)
        state = dataclasses.replace(state, grid=_move_obstacles(params, state, gumbels))

    agent_dir = state.agent_dir
    fwd = state.agent_pos + dir_vec[agent_dir]
    fx = fwd[:, 0].clamp(0, params.width - 1)
    fy = fwd[:, 1].clamp(0, params.height - 1)
    fwd_cell = state.grid[env, fx, fy]                  # [N, 3] int8
    fobj, fcol, fstate = fwd_cell[:, 0], fwd_cell[:, 1], fwd_cell[:, 2]

    # -- turn
    new_dir = torch.where(action == A_LEFT, (agent_dir - 1) % 4,
                          torch.where(action == A_RIGHT, (agent_dir + 1) % 4, agent_dir))

    # -- forward
    moves = (action == A_FORWARD) & _can_overlap(fwd_cell)
    new_pos = torch.where(moves[:, None], fwd, state.agent_pos)
    reached_goal = (action == A_FORWARD) & (fobj == GOAL)
    hit_lava = (action == A_FORWARD) & (fobj == LAVA)
    time_reward = _time_reward(step_count, params.max_steps)
    zero = torch.zeros_like(time_reward)

    # -- pickup / drop
    carrying_none = state.carrying[:, 0] == 0
    can_pickup = (fobj == KEY) | (fobj == BALL) | (fobj == BOX)
    does_pickup = (action == A_PICKUP) & can_pickup & carrying_none
    does_drop = (action == A_DROP) & (fobj == EMPTY) & ~carrying_none
    # -- toggle: doors open/close/unlock; a box is replaced by its contents
    # (a hidden key is 1 + key_color in the box's state channel)
    is_door = fobj == DOOR
    has_matching_key = (state.carrying[:, 0] == KEY) & (state.carrying[:, 1] == fcol)
    unlocks = is_door & (fstate == LOCKED) & has_matching_key
    opens = is_door & (fstate == CLOSED)
    closes = is_door & (fstate == OPEN)
    new_door_state = torch.where(
        unlocks | opens, torch.full_like(fstate, OPEN),
        torch.where(closes, torch.full_like(fstate, CLOSED), fstate))
    does_toggle = (action == A_TOGGLE) & is_door
    does_toggle_box = (action == A_TOGGLE) & (fobj == BOX)

    empty_cell = torch.zeros_like(fwd_cell)
    empty_cell[:, 0] = EMPTY
    toggled_cell = torch.stack([fobj, fcol, new_door_state], dim=-1)
    key_cell = torch.stack([torch.full_like(fobj, KEY), fstate - 1, torch.zeros_like(fobj)], dim=-1)
    box_contents = torch.where((fstate > 0)[:, None], key_cell, empty_cell)
    new_fwd_cell = torch.where(
        does_pickup[:, None], empty_cell,
        torch.where(does_drop[:, None], state.carrying,
                    torch.where(does_toggle[:, None], toggled_cell,
                                torch.where(does_toggle_box[:, None], box_contents, fwd_cell))))
    grid = state.grid.clone()
    grid[env, fx, fy] = new_fwd_cell

    if params.success == "open_door":
        # Unlock: a toggle that leaves the door open terminates with the
        # time-scaled reward; there is no goal square (upstream unlock.py).
        won = does_toggle & (new_door_state == OPEN)
        terminated = won | hit_lava
    elif params.success == "pickup_box":
        # UnlockPickup: picking the box up (upstream unlockpickup.py).
        won = does_pickup & (fobj == BOX)
        terminated = won | hit_lava
    elif params.success == "pickup_ball":
        # KeyCorridor / ObstructedMaze: picking the target ball up;
        # ``target_color`` tells it from ObstructedMaze's door blocker.
        won = does_pickup & (fobj == BALL)
        if params.target_color >= 0:
            won = won & (fcol == params.target_color)
        terminated = won | hit_lava
    elif params.success == "red_then_blue":
        # RedBlueDoors (upstream redbluedoors.py step()): the episode ends
        # whenever the blue door is open after the transition — rewarded
        # iff the red door was open BEFORE it; opening red while blue was
        # already open also terminates with 0.
        red_before, blue_before = _door_open(state.grid, RED), _door_open(state.grid, BLUE)
        red_after, blue_after = _door_open(grid, RED), _door_open(grid, BLUE)
        won = blue_after & red_before
        terminated = won | (blue_after & ~red_before) | (red_after & ~red_before & blue_before)
    else:
        won = reached_goal
        terminated = reached_goal | hit_lava
    reward = torch.where(won, time_reward, zero)
    carrying = torch.where(does_pickup[:, None], fwd_cell,
                           torch.where(does_drop[:, None], torch.zeros_like(fwd_cell),
                                       state.carrying))

    target, instr, instr_state = state.target, state.instr, state.instr_state
    if params.success == "goto_door":
        # GoToDoor (upstream gotodoor.py step): any toggle or ``done``
        # terminates; ``done`` axially adjacent to the target door (same x
        # within |Δy| < 2, or same y within |Δx| < 2) earns the reward.
        tx, ty = target[:, 2], target[:, 3]
        adjacent = (((new_pos[:, 0] == tx) & ((new_pos[:, 1] - ty).abs() < 2))
                    | ((new_pos[:, 1] == ty) & ((new_pos[:, 0] - tx).abs() < 2)))
        terminated = terminated | (action == A_TOGGLE) | (action == A_DONE)
        reward = torch.where((action == A_DONE) & adjacent, time_reward, reward)
    elif params.success == "fetch":
        # Fetch (upstream fetch.py step): carrying anything after the step
        # terminates, rewarded iff its (type, color) is the mission's.
        has = carrying[:, 0] != 0
        match = (carrying[:, 0].int() == target[:, 0]) & (carrying[:, 1].int() == target[:, 1])
        terminated = terminated | has
        reward = torch.where(has & match, time_reward, reward)
    elif params.success == "goto_object":
        # GoToObject (upstream gotoobject.py step): toggle or ``done``
        # terminates; ``done`` within Chebyshev distance 1 of the target's
        # position at reset earns the reward.
        near = ((new_pos[:, 0] - target[:, 2]).abs() <= 1) & ((new_pos[:, 1] - target[:, 3]).abs() <= 1)
        terminated = terminated | (action == A_TOGGLE) | (action == A_DONE)
        reward = torch.where((action == A_DONE) & near, time_reward, reward)
    elif params.success == "memory":
        # Memory (upstream memory.py step): standing on the success cell
        # after the step terminates with the reward, on the failure cell
        # with 0.
        on_success = (new_pos[:, 0] == target[:, 0]) & (new_pos[:, 1] == target[:, 1])
        on_failure = (new_pos[:, 0] == target[:, 2]) & (new_pos[:, 1] == target[:, 3])
        terminated = terminated | on_success | on_failure
        reward = torch.where(on_success, time_reward, torch.where(on_failure, zero, reward))
    elif params.success == "putnear":
        # PutNear (upstream putnear.py step): a pickup that leaves the agent
        # carrying anything but the move object terminates with 0; any drop
        # action while carrying terminates, even one that fails, rewarded
        # iff the object landed within Chebyshev distance 1 of the near
        # target.
        wrong_pickup = (action == A_PICKUP) & (carrying[:, 0] != 0) & ~(
            (carrying[:, 0].int() == target[:, 0]) & (carrying[:, 1].int() == target[:, 1]))
        drops = (action == A_DROP) & ~carrying_none
        landed_near = does_drop & ((fx - target[:, 4]).abs() <= 1) & ((fy - target[:, 5]).abs() <= 1)
        terminated = terminated | wrong_pickup | drops
        reward = torch.where(drops & landed_near, time_reward, reward)
    elif params.success == "babyai_seq":
        # Composite instructions (upstream RoomGridLevel.step → instrs.verify).
        succ, fail, instr, instr_state = _seq_verify(params, state, action, grid, new_pos,
                                                     new_dir, fx, fy, fobj, fcol, does_pickup,
                                                     does_drop, carrying)
        terminated = terminated | succ | fail
        reward = torch.where(succ, time_reward, reward)
    elif params.success.startswith("babyai_"):
        succ, fail = _babyai_verify(params, state, action, grid, new_pos, new_dir, fx, fy,
                                    fobj, fcol, does_pickup, carrying)
        terminated = terminated | succ | fail
        reward = torch.where(succ, time_reward, reward)

    if params.kind == "dynobs":
        # Forward into a pre-move-occupied non-goal cell → −1, episode over.
        collided = (action == A_FORWARD) & not_clear
        terminated = terminated | collided
        reward = torch.where(collided, torch.full_like(reward, -1.0), reward)

    truncated = step_count >= params.max_steps
    new_state = EnvState(grid, new_pos, new_dir, carrying, step_count, target, instr, instr_state)
    return new_state, reward, terminated, truncated


# ---------------------------------------------------------------------------
# Observation (7×7×3 egocentric partial view)
# ---------------------------------------------------------------------------


def _process_vis(view: torch.Tensor) -> torch.Tensor:
    """MiniGrid's shadow-casting visibility over the rotated [N, 7, 7] view:
    a cell lets light through unless it is a wall or a non-open door."""
    obj, st = view[..., 0], view[..., 2]
    clear = ~((obj == WALL) | ((obj == DOOR) & (st != OPEN)))
    mask = torch.zeros(obj.shape, dtype=torch.bool, device=view.device)
    mask[:, _AGENT_VIEW_POS[0], _AGENT_VIEW_POS[1]] = True
    for j in reversed(range(VIEW_SIZE)):
        for i in range(VIEW_SIZE - 1):
            vis = mask[:, i, j] & clear[:, i, j]
            mask[:, i + 1, j] |= vis
            if j > 0:
                mask[:, i + 1, j - 1] |= vis
                mask[:, i, j - 1] |= vis
        for i in reversed(range(1, VIEW_SIZE)):
            vis = mask[:, i, j] & clear[:, i, j]
            mask[:, i - 1, j] |= vis
            if j > 0:
                mask[:, i - 1, j - 1] |= vis
                mask[:, i, j - 1] |= vis
    return mask


def observe(params: EnvParams, state: EnvState) -> torch.Tensor:
    """Egocentric ``[N, 7, 7, 3]`` uint8 observations, axis 1 = view x
    (MiniGrid ``gen_obs()['image']`` through ImgObsWrapper)."""
    device = state.grid.device
    n = state.grid.shape[0]
    dir_vec = torch.as_tensor(DIR_TO_VEC, device=device)
    f = dir_vec[state.agent_dir]                 # [N, 2] forward
    r = dir_vec[(state.agent_dir + 1) % 4]       # [N, 2] right
    vx = torch.arange(VIEW_SIZE, device=device).reshape(1, VIEW_SIZE, 1)
    vy = torch.arange(VIEW_SIZE, device=device).reshape(1, 1, VIEW_SIZE)
    steps_fwd = _AGENT_VIEW_POS[1] - vy
    steps_right = vx - _AGENT_VIEW_POS[0]
    wx = state.agent_pos[:, 0, None, None] + f[:, 0, None, None] * steps_fwd + r[:, 0, None, None] * steps_right
    wy = state.agent_pos[:, 1, None, None] + f[:, 1, None, None] * steps_fwd + r[:, 1, None, None] * steps_right
    in_bounds = (wx >= 0) & (wx < params.width) & (wy >= 0) & (wy < params.height)
    env = torch.arange(n, device=device).reshape(n, 1, 1)
    cells = state.grid[env, wx.clamp(0, params.width - 1), wy.clamp(0, params.height - 1)]
    wall_cell = torch.tensor([WALL, GREY, 0], dtype=torch.int8, device=device)
    view = torch.where(in_bounds[..., None], cells, wall_cell)
    if not params.see_through_walls:
        vis = _process_vis(view)
        view = torch.where(vis[..., None], view, torch.zeros_like(view))
    # Agent cell shows the carried object (or empty if hands are free).
    empty = torch.tensor([EMPTY, 0, 0], dtype=torch.int8, device=device)
    carried = torch.where((state.carrying[:, 0] != 0)[:, None], state.carrying, empty)
    view[:, _AGENT_VIEW_POS[0], _AGENT_VIEW_POS[1]] = carried
    return view.to(torch.uint8)


# RGB palette matching MiniGrid's COLORS map (minigrid rendering).
_COLOR_RGB = np.array(
    [
        [255, 0, 0],     # red
        [0, 255, 0],     # green
        [0, 0, 255],     # blue
        [112, 39, 195],  # purple
        [255, 255, 0],   # yellow
        [100, 100, 100], # grey
    ],
    dtype=np.uint8,
)


def render_rgb(params: EnvParams, grid: torch.Tensor, agent_pos: torch.Tensor,
               agent_dir: torch.Tensor, tile_px: int = 6) -> torch.Tensor:
    """Top-down RGB render of ONE env's full grid ([W, H, 3] grid, [2] pos,
    [] dir) → [H·tile, W·tile, 3] uint8: colored tiles per object, grid
    lines, and a red directional agent marker."""
    device = grid.device
    w, h = params.width, params.height
    px = torch.arange(w * tile_px, device=device).reshape(1, -1)
    py = torch.arange(h * tile_px, device=device).reshape(-1, 1)
    cx, cy = px // tile_px, py // tile_px
    ix, iy = px % tile_px, py % tile_px
    obj = grid[..., 0][cx, cy]
    col = grid[..., 1][cx, cy]
    st = grid[..., 2][cx, cy]

    colors = torch.as_tensor(_COLOR_RGB, device=device)
    base = colors[col.long().clamp(0, 5)]
    img = torch.where((obj == WALL)[..., None], base, torch.zeros_like(base))
    img = torch.where((obj == GOAL)[..., None], colors[GREEN], img)
    img = torch.where((obj == LAVA)[..., None], torch.tensor([255, 128, 0], dtype=torch.uint8,
                                                             device=device), img)
    inset = (ix >= 1) & (ix < tile_px - 1) & (iy >= 1) & (iy < tile_px - 1)
    small = (obj == KEY) | (obj == BALL) | (obj == BOX)
    img = torch.where((small & inset)[..., None], base, img)
    door = obj == DOOR
    frame_px = (ix == 0) | (ix == tile_px - 1) | (iy == 0) | (iy == tile_px - 1)
    img = torch.where((door & (st != OPEN))[..., None], base, img)
    img = torch.where((door & (st == OPEN) & frame_px)[..., None], base, img)

    on_agent = (cx == agent_pos[0]) & (cy == agent_pos[1])
    t = tile_px
    tris = torch.stack([
        ix >= (2 * iy - (t - 1)).abs(),            # right
        iy >= (2 * ix - (t - 1)).abs(),            # down
        (t - 1 - ix) >= (2 * iy - (t - 1)).abs(),  # left
        (t - 1 - iy) >= (2 * ix - (t - 1)).abs(),  # up
    ])
    tri = tris[agent_dir]
    img = torch.where((on_agent & tri)[..., None], colors[RED], img)
    line = (ix == 0) | (iy == 0)
    img = torch.where((line & (obj == EMPTY))[..., None],
                      torch.tensor([40, 40, 40], dtype=torch.uint8, device=device), img)
    return img.to(torch.uint8)


# ---------------------------------------------------------------------------
# Text descriptions (host numpy)
# ---------------------------------------------------------------------------


def describe_rollout(grids: np.ndarray, agent_pos: np.ndarray, agent_dir: np.ndarray) -> list[str]:
    """Descriptions for a whole rollout, flattened t-major to match the
    training batch layout ([T, N] → index t·N + n).

    ``grids`` is one [N, W, H, 3] snapshot (not per-step): the description's
    object list is the first 3 non-empty cells in x-major scan order, which
    on any bordered MiniGrid grid are the static border walls at
    (0,0),(0,1),(0,2) — so any snapshot of the same episode yields the
    identical list the reference computes per step
    (`clip_ppo_minigrid.py:164-211`). The grid scan therefore runs once
    per env (N), not once per sample (T·N).

    Known approximation, the JAX package's own and kept for parity: where
    the suffix varies across episodes (MultiRoom, whose grid has no
    border; GoToDoor), every step of the rollout takes its env's suffix
    from this last snapshot, so the steps before a mid-rollout autoreset
    carry the next episode's suffix.
    """
    t, n = agent_dir.shape
    grids = np.asarray(grids)
    suffixes = [_objects_suffix(grids[i]) for i in range(n)]
    agent_pos = np.asarray(agent_pos).reshape(t * n, 2)
    agent_dir = np.asarray(agent_dir).reshape(t * n)
    return [f"agent at ({int(agent_pos[i][0])},{int(agent_pos[i][1])}) "
            f"facing {DIR_NAMES[int(agent_dir[i])]}" + suffixes[i % n] for i in range(t * n)]


def _objects_suffix(grid: np.ndarray, max_objects: int = 3) -> str:
    """", objects: ..." suffix from one grid's first non-empty cells."""
    objs = []
    w, h = grid.shape[:2]
    for x in range(w):
        for y in range(h):
            o = int(grid[x, y, 0])
            if o not in (UNSEEN, EMPTY):
                objs.append(f"{IDX_TO_OBJECT[o]} at ({x},{y})")
                if len(objs) >= max_objects:
                    return f", objects: {', '.join(objs)}"
    return f", objects: {', '.join(objs)}" if objs else ""


def describe_states(grids: np.ndarray, agent_pos: np.ndarray, agent_dir: np.ndarray,
                    max_objects: int = 3) -> list[str]:
    """Symbolic text descriptions from batched env state (host-side), the
    reference's `_get_symbolic_descriptions` (`clip_ppo_minigrid.py:164-211`):
    agent position/direction plus the first ``max_objects`` non-empty cells
    in x-major scan order."""
    grids, agent_pos, agent_dir = np.asarray(grids), np.asarray(agent_pos), np.asarray(agent_dir)
    return [f"agent at ({int(agent_pos[b][0])},{int(agent_pos[b][1])}) "
            f"facing {DIR_NAMES[int(agent_dir[b])]}" + _objects_suffix(grids[b], max_objects)
            for b in range(grids.shape[0])]
